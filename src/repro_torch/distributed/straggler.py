"""Straggler detection and mitigation hooks.

On a real pod, per-host step times diverge when a host degrades (thermals,
ECC retries, network incast).  The monitor keeps a robust running estimate
of the step-time distribution and flags outliers; the mitigation policy is
pluggable — the trainer consumes ``should_rebalance`` to shrink the slow
host's microbatch share (the data pipeline's ``shard_at`` is elastic in the
shard->slice mapping, so re-balancing is a pure metadata change).

``StepMonitor`` is consumer-agnostic: the design sweep wraps each bucket
evaluation in ``start()``/``stop()`` the same way (``dse.explore`` surfaces
the flagged stalls on ``DSEResult.meta['stalls']``).

The port's own copy of the JAX package's ``distributed/straggler.py``
(the standard library only): the JAX package's ``distributed/__init__.py``
imports JAX, so the port cannot import it from there.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float
    ratio: float
    label: str = ""  # pipeline stage ('assign', 'refit', ...) or ""


class StepMonitor:
    """EWMA/median hybrid step-time monitor with an outlier threshold.

    ``start(label=...)`` tags the step with a pipeline stage so a
    multi-stage consumer (the streaming service times its assignment
    batches and online re-fits through one monitor) can attribute a
    flagged stall; the label is observability metadata only — the
    outlier threshold compares against the pooled median.
    """

    def __init__(self, window: int = 50, threshold: float = 2.0, warmup: int = 5):
        self.window = window
        self.threshold = threshold
        self.warmup = warmup
        self.times: deque = deque(maxlen=window)
        self.events: list = []
        self._t0: Optional[float] = None
        self._label = ""
        self._step = 0

    def start(self, label: str = "") -> None:
        self._t0 = time.perf_counter()
        self._label = label

    def stop(self) -> Optional[StragglerEvent]:
        if self._t0 is None:
            return None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe_next(dt, self._label)

    def observe_next(
        self, duration_s: float, label: str = ""
    ) -> Optional[StragglerEvent]:
        """Record the next step's duration, timed by the caller's own
        clock readings (``stop`` times it from ``start``)."""
        self._step += 1
        return self.observe(self._step, duration_s, label=label)

    def observe(
        self, step: int, duration_s: float, label: str = ""
    ) -> Optional[StragglerEvent]:
        """Record a step duration; returns an event if it is a straggler."""
        ev = None
        if len(self.times) >= self.warmup:
            med = sorted(self.times)[len(self.times) // 2]
            if med > 0 and duration_s > self.threshold * med:
                ev = StragglerEvent(
                    step, duration_s, med, duration_s / med, label
                )
                self.events.append(ev)
        self.times.append(duration_s)
        return ev

    @property
    def median_s(self) -> float:
        if not self.times:
            return 0.0
        return sorted(self.times)[len(self.times) // 2]

    def should_rebalance(self, patience: int = 3) -> bool:
        """True when `patience` straggler events landed within one window —
        a persistent slow host rather than a one-off hiccup."""
        if len(self.events) < patience:
            return False
        recent = self.events[-patience:]
        return recent[-1].step - recent[0].step < self.window


class RebalancePolicy:
    """Maps straggler evidence to per-shard microbatch weights.

    ``weights[i]`` scales shard i's slice of the global batch; the trainer
    applies it through the data pipeline.  Here: shave `shave` fraction off
    the slowest shard and spread it uniformly (the classic backup-worker
    alternative that does not duplicate compute).
    """

    def __init__(self, num_shards: int, shave: float = 0.25):
        self.weights = [1.0] * num_shards
        self.shave = shave

    def apply(self, slow_shard: int) -> list:
        take = self.weights[slow_shard] * self.shave
        self.weights[slow_shard] -= take
        others = len(self.weights) - 1
        for i in range(len(self.weights)):
            if i != slow_shard:
                self.weights[i] += take / others
        return list(self.weights)
