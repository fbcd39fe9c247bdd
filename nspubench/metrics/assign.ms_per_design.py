"""Time of fused_column.assign_padded, the padded assignment, per design, ms."""
from nspubench import readers


def read(ctx):
    return readers.per_design_ms(ctx, "assign", False)
