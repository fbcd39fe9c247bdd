"""The padded fused scans' schedule, and the device peaks of the roofline.

The port's counterpart of the JAX package's ``roofline/costmodel.py``,
kept to what the port runs:

* **The constants**: the JAX package's hand-tuned schedule, unchanged.
  A padded scan folds ``const_v_blk`` volleys per block (32 for the
  kernel lowering, one launch a block; 8 for ``'reference'``) and a
  design joins a shared envelope within ``CONST_WASTE_CAP``.
  ``constants_plan`` packages them as an ``ExecutionPlan``, the JAX
  package's record, so results can say what their schedule was.  Every
  block size and every envelope gives the same weights and ids.
* **DeviceProfile**: the peaks ``roofline/analysis.py`` reads (f32
  FLOP/s, streaming bandwidth, link bandwidth).  ``PROFILES`` holds
  named records; none is active unless ``override`` (or
  ``set_profile``) activates one.

What has no counterpart: the JAX package's device probes and the plan
it chooses from them (on the H100 that plan's waste cap was 1.7x slower
than the constants' and its block the same), ``xla_volley_cost`` and the
``envelope_cost`` disk store, ``trace_unroll``, and ``t_blk`` (no CUDA
kernel of the port tiles time).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

# The hand-tuned constants of the JAX package, unchanged: volleys folded
# per block (the kernel lowering folds a block in one launch; the
# reference lowering keeps blocks small), and the envelope waste cap.
CONST_V_BLK_REFERENCE = 8
CONST_V_BLK_KERNEL = 32
CONST_WASTE_CAP = 4.0


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """The roofline peaks of a card: ``peak_flops`` (f32 FLOP/s),
    ``hbm_bw`` (B/s) and ``link_bw``, the bandwidth between cards (0
    with one card)."""

    name: str
    platform: str           # 'cuda' | 'cpu'
    device_kind: str        # torch.cuda.get_device_name(0), or 'cpu'
    peak_flops: float
    hbm_bw: float
    link_bw: float
    n_devices: int = 1


# Named records, never active implicitly.  'h100-sxm' carries the
# data-sheet peaks of the NVIDIA H100 80GB HBM3 (SXM, 700 W): 67 TFLOP/s
# f32 outside the tensor cores, 3.35 TB/s HBM3, no link (one card).
PROFILES: dict[str, DeviceProfile] = {
    "h100-sxm": DeviceProfile(
        name="h100-sxm", platform="cuda", device_kind="NVIDIA H100 80GB HBM3",
        peak_flops=67e12, hbm_bw=3.35e12, link_bw=0.0,
    ),
}


# ------------------------------------------------------------ activation
# The active profile is process state, set explicitly (set_profile /
# override): the roofline reads it, nothing fills it.
_ACTIVE: Optional[DeviceProfile] = None


def profile() -> Optional[DeviceProfile]:
    """The active profile, or None."""
    return _ACTIVE


def set_profile(p: Optional[DeviceProfile]) -> Optional[DeviceProfile]:
    """Activate ``p`` (None deactivates); returns the previous one."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = p
    return prev


@contextlib.contextmanager
def override(p: Optional[DeviceProfile]):
    """Activate ``p`` for a block."""
    prev = set_profile(p)
    try:
        yield
    finally:
        set_profile(prev)


# ------------------------------------------------------------------ plan
@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The schedule of one padded fused scan.  Frozen and hashable.

    Contract (``plan_is_valid``): ``1 <= v_blk <= n_volleys``; ``shards``
    divides ``d``; ``waste_cap >= 1``.  Every legal plan gives the same
    result.
    """

    kind: str               # 'fit' | 'assign'
    lowering: str
    d: int
    n_volleys: int
    v_blk: int
    shards: int
    waste_cap: float

    def meta(self) -> dict:
        """JSON-ready record of the plan, the JAX package's keys (its
        constants plan predicts nothing and names no profile)."""
        return {
            "kind": self.kind,
            "lowering": self.lowering,
            "v_blk": self.v_blk,
            "shards": self.shards,
            "waste_cap": self.waste_cap,
            "predicted_step_us": 0.0,
            "source": "constants",
            "profile": "",
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


def constants_plan(kind: str, lowering: str, d: int, n_volleys: int) -> ExecutionPlan:
    """The plan of a padded scan: the constants above, on one card."""
    return ExecutionPlan(
        kind=kind, lowering=lowering, d=int(d),
        n_volleys=max(int(n_volleys), 1),
        v_blk=const_v_blk(lowering, n_volleys, d if kind == "fit" else None),
        shards=1,
        waste_cap=CONST_WASTE_CAP,
    )


def plan_is_valid(plan: ExecutionPlan) -> bool:
    """The plan contract as one predicate."""
    return (
        1 <= plan.v_blk <= max(plan.n_volleys, 1)
        and plan.shards >= 1
        and plan.d % plan.shards == 0
        and plan.waste_cap >= 1.0
    )
