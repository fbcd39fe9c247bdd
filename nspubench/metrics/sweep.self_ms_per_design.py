"""Time of simulator.cluster_time_series_many outside its padded fit and assignment (buckets, plans, host encode, Rand index) per design, ms."""
from nspubench import readers


def read(ctx):
    return readers.per_design_ms(ctx, "sweep", True)
