"""Share of its roofline the head-dim-224 flash kernel reaches over the window, %."""
from nspubench import lm_readers


def read(ctx):
    return lm_readers.flash_roofline_pct(ctx)
