"""Share of the experts a MoE block run hits (at least one assignment),
over every block of the window's prefills and decode steps, %."""
from nspubench import granite_readers


def read(ctx):
    return granite_readers.experts_hit_pct(ctx)
