"""Share of its roofline that the volley-block kernel reaches over the window, %."""
from nspubench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "fused_block")
