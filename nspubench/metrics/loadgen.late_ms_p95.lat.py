"""95th percentile of the generator's lateness, due time to submit, ms."""
from nspubench import readers


def read(ctx):
    return readers.p95_ms(ctx, "lateness_s")
