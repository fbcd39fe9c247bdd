"""Device time of a prefill's MoE blocks (the program's ``lm.moe`` spans,
timed by their CUDA events), ms."""
from nspubench import granite_readers


def read(ctx):
    return granite_readers.moe_prefill_ms_per_batch(ctx)
