"""Share of the window in which no operation ran on the device, %."""
from nspubench import lm_readers


def read(ctx):
    return lm_readers.idle_pct(ctx)
