"""Share of its roofline that the batched fire kernel reaches over the serving window, %."""
from nspubench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "fire_block")
