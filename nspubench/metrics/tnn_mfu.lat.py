"""Counted operations of the window's batches and re-fits over their summed spans at the float32 peak, %."""
from nspubench import readers


def read(ctx):
    return readers.mfu_serving(ctx)
