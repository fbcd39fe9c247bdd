"""Device kernels launched in the window per design."""
from nspubench import readers


def read(ctx):
    return readers.kernels_per(ctx, "designs")
