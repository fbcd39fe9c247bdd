"""Share of its roofline the MLA (192 / 128) flash kernel reaches over the window, %."""
from nspubench import mla_readers


def read(ctx):
    return mla_readers.flash_mla_roofline_pct(ctx)
