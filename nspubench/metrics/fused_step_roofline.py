"""Share of its roofline that the single-column fit kernel reaches over the window, %."""
from nspubench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "fused_step")
