"""Time of fused_column.fit_scan_padded per re-fit, ms."""
from nspubench import readers


def read(ctx):
    return readers.per_call_ms(ctx, "fit")
