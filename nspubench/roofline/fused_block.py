"""The volley-block training kernel (csrc/fused_block.cu).  An item is
one design's online fit on the sweep's or the service's path: its true
synapses p and neurons q, the real volleys it folded (``steps``, epochs
times the stream), the stream's length ``n`` and the fire's slope-form
work (up, down, cycles).  Bytes: the weights read and written once, the
stream read once, six operands."""
from nspubench.roofline import fire_ops, stdp_ops

KERNEL = "fused_block_kernel"


def count(fit: dict) -> tuple[int, int]:
    p, q = fit["p"], fit["q"]
    ops = fire_ops(*fit["work"]) + stdp_ops(p, q, fit["steps"])
    return ops, 4 * (2 * p * q + fit["n"] * p + 6)
