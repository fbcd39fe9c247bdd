"""Time of fused_column.assign_padded per served batch, ms."""
from nspubench import readers


def read(ctx):
    return readers.per_call_ms(ctx, "assign")
