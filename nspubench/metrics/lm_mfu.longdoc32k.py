"""Model FLOPs of the window's prefilled and decoded tokens over the window at the bf16 tensor-core peak, %."""
from nspubench import lm_readers


def read(ctx):
    return lm_readers.mfu_pct(ctx)
