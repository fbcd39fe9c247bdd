"""Share of the window in which no operation ran on the device, %."""
from nspubench import readers


def read(ctx):
    return readers.idle_pct(ctx)
