"""The batched fire kernel (csrc/fire_block.cu) on the serving path.  An
item is one batch: the (p, q) of each design of its bucket and, per
request, its design's (p, q) and the fire's slope-form work (up, down,
cycles).  Operations: each request's fire against its own design (lanes
the program leaves silent are its layout, not work the requests need).
Bytes: each design's weights read once, each request's volley read once
and its q firing times written once, six operands a design."""
from nspubench.roofline import fire_ops

KERNEL = "fire_block_kernel"


def count(batch: dict) -> tuple[int, int]:
    ops = sum(fire_ops(up, down, cycles) for (_, _, up, down, cycles) in batch["requests"])
    nbytes = 4 * (sum(p * q for p, q in batch["designs"])
                  + sum(p + q for (p, q, *_rest) in batch["requests"])
                  + 6 * len(batch["designs"]))
    return ops, nbytes
