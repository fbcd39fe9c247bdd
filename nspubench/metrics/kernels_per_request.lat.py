"""Device kernels launched in the window per request."""
from nspubench import readers


def read(ctx):
    return readers.kernels_per(ctx, "requests")
