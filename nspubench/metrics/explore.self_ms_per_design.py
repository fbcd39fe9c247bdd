"""Host and device time of dse.explore outside the sweep (candidates, forecast, Pareto) per design, ms."""
from nspubench import readers


def read(ctx):
    return readers.per_design_ms(ctx, "explore", True)
