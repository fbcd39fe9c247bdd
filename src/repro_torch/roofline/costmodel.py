"""Execution plans of the padded fused scans: the constants policy.

An ``ExecutionPlan`` packages every schedule knob of one padded scan (the
volley block, the design-axis shard count, the envelope waste cap) with
where it came from, so results can record why their schedule was what it
was.  The JAX package chooses plans from a device calibration when one is
active; the port has no calibration yet, so every plan here is the
constants plan (``source='constants'``), exactly what the JAX package
does on an uncalibrated host.  A plan changes the schedule only, never a
result.

The TPU kernels' time block ``t_blk`` has no counterpart: no CUDA kernel
of the port tiles the time window.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# The hand-tuned constants of the JAX package, unchanged: volleys folded
# per block (the kernel lowering folds a block in one launch; the
# reference lowering keeps blocks small), and the envelope waste cap.
CONST_V_BLK_REFERENCE = 8
CONST_V_BLK_KERNEL = 32
CONST_WASTE_CAP = 4.0


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """One schedule decision for a padded fused scan.

    Contract: ``1 <= v_blk <= n_volleys``; ``shards`` divides ``d``;
    ``waste_cap >= 1``.  Every legal plan gives the same result.
    """

    kind: str               # 'fit' | 'assign'
    lowering: str
    d: int
    n_volleys: int
    v_blk: int
    shards: int
    waste_cap: float
    predicted_step_s: float  # 0.0: the constants policy predicts nothing
    source: str              # 'constants'
    profile: str             # '' without a calibration

    def meta(self) -> dict:
        """JSON-ready record of the plan."""
        return {
            "kind": self.kind,
            "lowering": self.lowering,
            "v_blk": self.v_blk,
            "shards": self.shards,
            "waste_cap": self.waste_cap,
            "predicted_step_us": self.predicted_step_s * 1e6,
            "source": self.source,
            "profile": self.profile,
        }


def const_v_blk(lowering: str, n_volleys: int, d: Optional[int] = None) -> int:
    """The constants block policy: 32 volleys per block for the kernel
    lowering, 8 for 'reference' (capped at ``max(2, 2 d)`` when the
    design-axis length ``d`` is known), never more than the stream."""
    base = (
        CONST_V_BLK_REFERENCE if lowering == "reference"
        else CONST_V_BLK_KERNEL
    )
    if d is not None and lowering == "reference":
        base = min(base, max(2, 2 * int(d)))
    return max(1, min(base, int(n_volleys)))


def constants_plan(
    kind: str, lowering: str, d: int, n_volleys: int, shards: int = 1
) -> ExecutionPlan:
    """The plan of an uncalibrated host: the constants above, with the
    shard count of the caller's shard policy (``backend.design_shards``)."""
    return ExecutionPlan(
        kind=kind, lowering=lowering, d=int(d),
        n_volleys=max(int(n_volleys), 1),
        v_blk=const_v_blk(lowering, n_volleys, d if kind == "fit" else None),
        shards=int(shards),
        waste_cap=CONST_WASTE_CAP,
        predicted_step_s=0.0,
        source="constants",
        profile="",
    )
