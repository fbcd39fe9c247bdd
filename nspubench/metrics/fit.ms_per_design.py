"""Time of fused_column.fit_scan_padded, the padded fit, per design, ms."""
from nspubench import readers


def read(ctx):
    return readers.per_design_ms(ctx, "fit", False)
