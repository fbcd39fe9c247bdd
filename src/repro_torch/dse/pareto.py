"""Quality-vs-silicon Pareto analysis for design sweeps.

The paper's closing loop: every functional-simulation result is paired
with *forecasted* silicon metrics (area / leakage from the synapse count,
``repro_torch.hwgen.forecast``) so designs can be ranked without running the
hardware flow.  ``pareto_front`` extracts the nondominated set — the
designs for which no other design is at least as good on every objective
and strictly better on one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.types import ColumnConfig


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One evaluated design: clustering quality + forecasted silicon cost.

    ``index`` is the candidate's position in the explore order;
    ``params`` follows the unified ``ClusteringResult.params`` contract
    (``{'w': [p, q]}``).
    """

    index: int
    cfg: ColumnConfig
    encoder: str
    rand_index: float
    synapses: int
    area_um2: float
    leakage_uw: float
    params: dict
    lowering: str = ""
    buckets: int = 1
    shards: int = 1
    # Fault-tolerance provenance: the journal fingerprint of the
    # evaluation ('' outside journaled explore runs) and how many
    # degradation-ladder rungs failed before ``lowering`` ran (0 = the
    # first-choice lowering succeeded).
    fingerprint: str = ""
    retries: int = 0
    # ExecutionPlan.meta() of the fit that trained this design's bucket
    # (None when the cycle-solver fallback trained it, or on rows
    # restored from a pre-plan journal).
    plan: Optional[dict] = None


def dominates(a: DesignPoint, b: DesignPoint) -> bool:
    """True iff ``a`` is at least as good as ``b`` on every objective
    (rand index up, area and leakage down) and strictly better on one.
    NaN objectives never dominate and are never dominated (they carry no
    ordering information)."""
    ge = (
        a.rand_index >= b.rand_index
        and a.area_um2 <= b.area_um2
        and a.leakage_uw <= b.leakage_uw
    )
    gt = (
        a.rand_index > b.rand_index
        or a.area_um2 < b.area_um2
        or a.leakage_uw < b.leakage_uw
    )
    return ge and gt


def pareto_front(points: Sequence[DesignPoint]) -> list[DesignPoint]:
    """Nondominated subset of ``points``, sorted cheapest-area first.

    Points with a NaN rand index (unlabeled streams) are excluded — they
    cannot be ranked on quality, so a frontier over them would be
    meaningless.  An empty input (e.g. every candidate of a
    fault-isolated run quarantined) returns an empty frontier, never
    raises; ``DSEResult.best`` is the entry point that turns an empty
    frontier into a diagnostic error.
    """
    ranked = [p for p in points if not math.isnan(p.rand_index)]
    front = [
        p
        for p in ranked
        if not any(dominates(o, p) for o in ranked if o is not p)
    ]
    return sorted(front, key=lambda p: (p.area_um2, -p.rand_index))
