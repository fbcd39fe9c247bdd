"""Counted operations of the window's jobs over the window at the float32 peak, %."""
from nspubench import readers


def read(ctx):
    return readers.mfu_window(ctx)
