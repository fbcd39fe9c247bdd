"""Spans around the program's layers, and the device trace of a window.

Spans are recorded only in a traced run: the benchmark replaces an entry
point that the program looks up through its module (or a method of its
class) with a wrapper that times the call on the host clock and ends it
with a device synchronisation, so device time lands in the layer that
launched it.  A span's self time is its duration minus its children's.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import time
from typing import Optional

# (module, attribute or Class.method, span name)
ENTRY_POINTS = (
    ("repro_torch.dse.explore", "explore", "explore"),
    ("repro_torch.core.simulator", "cluster_time_series_many", "sweep"),
    ("repro_torch.core.simulator", "cluster_time_series", "single"),
    ("repro_torch.kernels.fused_column", "fit_scan_padded", "fit"),
    ("repro_torch.kernels.fused_column", "assign_padded", "assign"),
    ("repro_torch.kernels.fused_column", "fit_fused", "fit_fused"),
    ("repro_torch.serve.service", "ClusteringService.submit", "submit"),
    ("repro_torch.serve.service", "ClusteringService.flush", "flush"),
)


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    parent: int


class Spans:
    """In-memory spans of one run; ``install`` wraps the entry points and
    returns a function that puts them back."""

    def __init__(self, sync):
        self.sync = sync
        self.items: list[Span] = []
        self._stack: list[int] = []

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def timed(*a, **kw):
            idx = len(self.items)
            self.items.append(Span(name, time.perf_counter(), 0.0,
                                   self._stack[-1] if self._stack else -1))
            self._stack.append(idx)
            try:
                return fn(*a, **kw)
            finally:
                self.sync()
                self.items[idx].t1 = time.perf_counter()
                self._stack.pop()

        return timed

    def install(self, entry_points=ENTRY_POINTS):
        undo = []
        for mod_name, attr, name in entry_points:
            owner = importlib.import_module(mod_name)
            *path, last = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            orig = owner.__dict__[last]
            setattr(owner, last, self.wrap(name, orig))
            undo.append((owner, last, orig))

        def restore():
            for owner, last, orig in reversed(undo):
                setattr(owner, last, orig)

        return restore

    def total(self, name: str) -> float:
        return sum(s.t1 - s.t0 for s in self.items if s.name == name)

    def count(self, name: str) -> int:
        return sum(1 for s in self.items if s.name == name)

    def self_total(self, name: str) -> float:
        child = [0.0] * len(self.items)
        for s in self.items:
            if s.parent >= 0:
                child[s.parent] += s.t1 - s.t0
        return sum(s.t1 - s.t0 - child[i] for i, s in enumerate(self.items)
                   if s.name == name)

    def innermost(self, times: list) -> list:
        """Name of the deepest span open at each host time (None where no
        span is), by one sweep over the spans in start order."""
        order = sorted(range(len(times)), key=lambda k: times[k])
        out: list = [None] * len(times)
        stack: list[Span] = []
        i = 0
        for k in order:
            t = times[k]
            while i < len(self.items) and self.items[i].t0 <= t:
                while stack and stack[-1].t1 < self.items[i].t0:
                    stack.pop()
                stack.append(self.items[i])
                i += 1
            while stack and stack[-1].t1 < t:
                stack.pop()
            out[k] = stack[-1].name if stack else None
        return out


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float
    window_s: float
    kernels: dict            # name -> [seconds, count]
    n_kernels: int
    breakdown: dict


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    return int(f()) if f is not None else int(getattr(e, what + "_us")() * 1000)


def reduce_trace(prof, t0: float, t1: float, epoch_minus_perf_ns: int,
                 spans: Optional[Spans]) -> DeviceTrace:
    """Busy time (the union of device activity inside [t0, t1] on the host
    clock), device time by kernel name, the number of kernels, and the
    breakdown: the device operations that took most time and the idle
    gaps summed by the innermost span open on the host."""
    import torch

    lo = int(t0 * 1e9) + epoch_minus_perf_ns
    hi = int(t1 * 1e9) + epoch_minus_perf_ns
    ivals, kernels, n_kernels = [], {}, 0
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        s = _ns(e, "start")
        d = _ns(e, "duration")
        a, b = max(s, lo), min(s + d, hi)
        if b <= a:
            continue
        name = e.name()
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += d / 1e9
        k[1] += 1
        if not name.startswith(("Memcpy", "Memset")):
            n_kernels += 1
        ivals.append((a, b))
    ivals.sort()
    busy, gaps, cur = 0, [], None
    for a, b in ivals:
        if cur is None:
            if a > lo:
                gaps.append((lo, a))
            cur = [a, b]
        elif a <= cur[1]:
            cur[1] = max(cur[1], b)
        else:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], a))
            cur = [a, b]
    if cur is not None:
        busy += cur[1] - cur[0]
        if cur[1] < hi:
            gaps.append((cur[1], hi))
    else:
        gaps.append((lo, hi))
    mids = [((a + b) / 2 - epoch_minus_perf_ns) / 1e9 for a, b in gaps]
    labels = spans.innermost(mids) if spans is not None else [None] * len(gaps)
    by_host: dict = {}
    for (a, b), label in zip(gaps, labels):
        label = label or "harness"
        by_host[label] = by_host.get(label, 0.0) + (b - a) / 1e9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return DeviceTrace(
        busy_s=busy / 1e9, window_s=t1 - t0, kernels=kernels, n_kernels=n_kernels,
        breakdown={
            "device_ops": [[n[:160], v[0]] for n, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(by_host.items(),
                                                      key=lambda kv: -kv[1])[:10]],
        })
