"""Share of the routed experts a MoE block run hits (at least one
assignment), over every block of the window's prefills and decode steps,
%."""
from nspubench import mla_readers


def read(ctx):
    return mla_readers.experts_hit_pct(ctx)
