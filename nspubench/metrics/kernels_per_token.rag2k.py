"""Device kernels launched in the window per decoded token of a request."""
from nspubench import lm_readers


def read(ctx):
    return lm_readers.kernels_per_decoded_token(ctx)
