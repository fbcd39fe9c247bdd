"""Share of its roofline the SSD scan kernel reaches over the window, %."""
from nspubench import granite_readers


def read(ctx):
    return granite_readers.ssd_roofline_pct(ctx)
