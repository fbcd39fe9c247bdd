"""Time of simulator.cluster_time_series outside its fused fit (encode, assignment on the event solver, Rand index) per design, ms."""
from nspubench import readers


def read(ctx):
    return readers.per_design_ms(ctx, "single", True)
