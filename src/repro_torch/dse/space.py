"""Design-space definitions for NSPU exploration.

A ``DesignSpace`` names the axes the TNNGen papers sweep when sizing a
sensory processing unit for a stream: neuron count ``q`` (cluster
capacity), temporal window ``t_max`` (gamma-cycle length), firing
threshold (as a scale on the simulator's operating-point suggestion,
so one scale means the same thing across geometries), and the spike
encoder.  ``grid`` enumerates the full cross product; ``sample`` draws a
random subset for large spaces — the two search modes ``dse.explore``
offers.  The port's counterpart of the JAX package's ``dse/space.py``:
the same candidates, in the same order, with the same configs.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Sequence

from repro_torch.core import simulator
from repro_torch.core.types import ColumnConfig

ENCODERS = ("latency", "onoff")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the design space — the free axes of a column design.

    ``threshold_scale`` multiplies ``simulator.suggest_threshold`` for the
    candidate's geometry, so thresholds stay meaningful as p and q vary.
    """

    q: int
    t_max: int
    threshold_scale: float = 1.0
    encoder: str = "latency"


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Axes of a column-design sweep; the cross product is the space.

    Attributes:
      q: neuron counts to sweep (cluster capacity).
      t_max: temporal windows to sweep.
      threshold_scale: multiples of the suggested operating-point
        threshold.
      encoder: spike encoders ('latency' and/or 'onoff'); 'onoff' doubles
        the input width p, so candidates with different encoders sweep in
        separate groups.
    """

    q: Sequence[int]
    t_max: Sequence[int]
    threshold_scale: Sequence[float] = (1.0,)
    encoder: Sequence[str] = ("latency",)

    def __post_init__(self):
        for axis in ("q", "t_max", "threshold_scale", "encoder"):
            if not tuple(getattr(self, axis)):
                raise ValueError(f"DesignSpace.{axis} must be non-empty")
        bad = set(self.encoder) - set(ENCODERS)
        if bad:
            raise ValueError(f"unknown encoders: {sorted(bad)}")

    def size(self) -> int:
        return (
            len(self.q) * len(self.t_max)
            * len(self.threshold_scale) * len(self.encoder)
        )

    def grid(self) -> list[Candidate]:
        """The full cross product, in deterministic axis-major order."""
        return [
            Candidate(q=q, t_max=t, threshold_scale=s, encoder=e)
            for e, q, t, s in itertools.product(
                self.encoder, self.q, self.t_max, self.threshold_scale
            )
        ]

    def sample(self, n: int, seed: int = 0) -> list[Candidate]:
        """``n`` distinct candidates drawn uniformly from the grid
        (deterministic per seed; ``n`` is clamped to the space size)."""
        grid = self.grid()
        rng = random.Random(seed)
        n = min(int(n), len(grid))
        if n <= 0:
            raise ValueError("sample needs a positive candidate budget")
        return rng.sample(grid, n)


def candidate_config(cand: Candidate, series_len: int) -> ColumnConfig:
    """Materialize a candidate into a ``ColumnConfig`` for an [N, L] stream.

    The encoder pins the input width (latency: p == L, on/off: p == 2L);
    the threshold is ``threshold_scale`` times the suggested operating
    point for the resulting geometry.
    """
    p = series_len if cand.encoder == "latency" else 2 * series_len
    cfg = ColumnConfig(p=p, q=cand.q, t_max=cand.t_max)
    return cfg.with_threshold(
        cand.threshold_scale * simulator.suggest_threshold(cfg)
    )
