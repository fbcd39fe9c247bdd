"""Device time of a prefill's MLA blocks (the program's ``lm.mla`` spans,
timed by their CUDA events), ms."""
from nspubench import mla_readers


def read(ctx):
    return mla_readers.mla_prefill_ms_per_batch(ctx)
