"""The single-column training kernel (csrc/fused_step.cu), which folds a
whole fit, epochs times the stream, in one launch.  An item is one fit,
as for ``fused_block``: the same operations (the algorithm does not
change with the kernel), and the weights read and written once, the
stream once, six operands."""
from nspubench.roofline import fire_ops, stdp_ops

KERNEL = "fused_fit_kernel"


def count(fit: dict) -> tuple[int, int]:
    p, q = fit["p"], fit["q"]
    ops = fire_ops(*fit["work"]) + stdp_ops(p, q, fit["steps"])
    return ops, 4 * (2 * p * q + fit["n"] * p + 6)
