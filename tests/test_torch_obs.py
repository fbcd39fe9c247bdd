"""The port's tracer (``repro_torch.obs``) on the three TNN paths.

On the CPU: with tracing off a service run, a sweep and a single-column
fit leave nothing and never read the tracer's clock; with tracing on
every id, weight and assignment is bit-identical to tracing off; the span
trees, the per-request records and the counters hold against hand
arithmetic.  One ``cuda`` test holds a program span against the device
trace on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_obs.py

Imports torch and the port only (no JAX), so it runs where JAX is absent.
"""
from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import encoding, simulator
from repro_torch.core.types import ColumnConfig, STDPConfig
from repro_torch.dse import DesignSpace, explore
from repro_torch.kernels import fused_column
from repro_torch.serve import ClusteringService, ServeFailure, ServeResult
from repro_torch.testing import faults

P, T_MAX = 12, 16
GRID = STDPConfig(mu_capture=1.0, mu_backoff=1.0, mu_search=1.0,
                  stabilizer="none")
EMPTY = {"spans": [], "counters": {}, "requests": [], "kernels": {}}


@pytest.fixture(autouse=True)
def tracer():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _cfg(q=4, t_max=T_MAX, grid=True) -> ColumnConfig:
    c = ColumnConfig(p=P, q=q, t_max=t_max,
                     stdp=GRID if grid else STDPConfig())
    return c.with_threshold(simulator.suggest_threshold(c))


FLEET = {"a": _cfg(3), "b": _cfg(4), "c": _cfg(3, 2 * T_MAX),
         "d": _cfg(5, 2 * T_MAX)}


def _service(batch_size=4, refit_every=4, refit_window=4, designs=FLEET,
             seed=0):
    rng = np.random.default_rng(seed)
    weights = {n: rng.integers(0, 8, (c.p, c.q)).astype(np.float32)
               for n, c in designs.items()}
    svc = ClusteringService(designs, batch_size=batch_size,
                            refit_every=refit_every, refit_window=refit_window,
                            weights=weights, device="cpu")
    svc.warmup()
    return svc


def _serve(trace: bool, n=37, seed=0):
    """A service run: n requests over the fleet, then a flush.  Tracing
    (when on) starts after the warm-up, as a measured window would."""
    svc = _service(seed=seed)
    if trace:
        obs.enable()
    rng = np.random.default_rng(seed + 1)
    names = list(FLEET)
    handles = [svc.submit(rng.normal(size=P), names[i % len(names)])
               for i in range(n)]
    svc.flush()
    obs.disable()
    return svc, handles


def _serve_out(trace: bool):
    svc, handles = _serve(trace)
    return ([h.outcome.cluster for h in handles],
            [svc.weights(n) for n in FLEET])


def _data(n=24, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, P)), rng.integers(0, 3, n)


SWEEP = [_cfg(3, 8, grid=False), _cfg(5, T_MAX, grid=False)]


def _sweep_out(trace: bool, callback=None):
    x, y = _data()
    if trace:
        obs.enable()
    out = simulator.cluster_time_series_many(
        x, y, SWEEP, epochs=2, seed=1, waste_cap=float("inf"),
        bucket_callback=callback, device="cpu")
    obs.disable()
    return [(r.assignments, r.params["w"].numpy(), r.rand_index) for r in out]


def _single_out(trace: bool):
    x, y = _data()
    if trace:
        obs.enable()
    r = simulator.cluster_time_series(x, y, _cfg(), epochs=2, seed=2,
                                      device="cpu")
    obs.disable()
    return [(r.assignments, r.params["w"].numpy(), r.rand_index)]


PATHS = {"serve": _serve_out, "sweep": _sweep_out, "single": _single_out}


class _NoClock:
    def perf_counter(self):
        raise AssertionError("the tracer read the clock with tracing off")


def test_tracing_off_records_nothing_and_reads_no_clock(monkeypatch):
    monkeypatch.setattr(obs, "time", _NoClock())
    for run in PATHS.values():
        run(trace=False)
    assert obs.snapshot() == EMPTY
    assert obs.span("serve.batch") is obs.NOOP


@pytest.mark.parametrize("path", sorted(PATHS))
def test_tracing_on_changes_no_result(path):
    off = PATHS[path](trace=False)
    on = PATHS[path](trace=True)
    assert obs.snapshot()["spans"], "tracing on recorded no span"
    for a, b in zip(off, on, strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _tree(spans, parent=-1) -> list:
    """Span names as nested (name, children) in start order."""
    return [(s[0], _tree(spans, i)) for i, s in enumerate(spans)
            if s[3] == parent]


BATCH = ("serve.batch", [("serve.assemble", []), ("serve.fire", []),
                         ("serve.d2h", []), ("serve.complete", [])])
REFIT = ("serve.refit", [("serve.refit_window", []), ("serve.refit_fit", []),
                         ("serve.refit_check", []), ("serve.commit", [])])
ADMIT = ("serve.admit", [("serve.encode", [])])
BUCKET = ("sweep.bucket", [("sweep.pad", []), ("sweep.plan", []),
                           ("sweep.fit", []), ("sweep.assign", []),
                           ("sweep.score", []), ("sweep.callback", [])])
SWEEP_RUN = ("sweep.run", [("sweep.encode", []), ("sweep.encode", []),
                           ("sweep.init", []), ("sweep.buckets", []), BUCKET])


def _serve_tree():
    """One full batch that triggers one re-fit, then a flushed partial
    batch."""
    svc = _service(batch_size=2, refit_every=2, refit_window=2,
                   designs={"a": FLEET["a"]})
    obs.enable()
    rng = np.random.default_rng(5)
    for _ in range(3):
        svc.submit(rng.normal(size=P), "a")
    svc.flush()
    return svc


def _explore_tree():
    x, y = _data()
    obs.enable()
    explore(x, y, DesignSpace(q=(3,), t_max=(8, T_MAX)), epochs=1,
            device="cpu")


TREES = {
    "serve": (_serve_tree,
              [ADMIT, ADMIT, BATCH, REFIT, ADMIT,
               ("serve.flush", [BATCH])]),
    "sweep": (lambda: _sweep_out(True, callback=lambda idxs, out: None),
              [SWEEP_RUN]),
    "single": (lambda: _single_out(True),
               [("single.column", [("single.encode", []),
                                   ("single.init", []), ("single.fit", []),
                                   ("single.assign", []),
                                   ("single.score", [])])]),
    "explore": (_explore_tree,
                [("dse.explore", [("explore.prepare", []),
                                  ("explore.prepare", []), SWEEP_RUN,
                                  ("explore.rank", [])])]),
}


@pytest.mark.parametrize("path", sorted(TREES))
def test_span_tree(path):
    run, want = TREES[path]
    run()
    spans = obs.snapshot()["spans"]
    assert _tree(spans) == want
    for name, t0, t1, parent, _ in spans:
        assert t0 <= t1, name
        if parent >= 0:
            _, p0, p1, _, _ = spans[parent]
            assert p0 <= t0 and t1 <= p1, (name, spans[parent][0])


def test_serving_span_attributes_and_refit_count():
    svc = _serve_tree()
    snap = obs.snapshot()
    spans = snap["spans"]
    admits = [s[4] for s in spans if s[0] == "serve.admit"]
    assert admits == [(0,), (1,), (2,)]
    batches = [s[4] for s in spans if s[0] == "serve.batch"]
    assert batches == [(0, 2, (0, 1)), (0, 1, (2,))]
    assert [s[4] for s in spans if s[0] == "serve.refit"] == [(0,)]
    commits = [s for s in spans if s[0] == "serve.commit"]
    assert len(commits) == svc.stats().refits == 1


def test_every_served_request_has_one_ordered_record():
    _, handles = _serve(trace=True)
    recs = {r[0]: r for r in obs.snapshot()["requests"]}
    assert len(recs) == len(obs.snapshot()["requests"]) == len(handles)
    for h in handles:
        rid, t_adm, t_disp, t_done, status = recs[h.id]
        assert isinstance(h.outcome, ServeResult) and status == "served"
        assert t_adm <= t_disp <= t_done


def test_quarantined_request_is_recorded_failed(monkeypatch):
    svc = _service(batch_size=4, refit_every=0, designs={"a": FLEET["a"]})
    rng = np.random.default_rng(9)
    poison = np.full(P, 2.5)
    monkeypatch.setattr(fused_column, "assign_padded", faults.fail_on_volley(
        fused_column.assign_padded,
        encoding.encode(torch.as_tensor(poison, dtype=torch.float32),
                        T_MAX).numpy()))
    obs.enable()
    handles = [svc.submit(rng.normal(size=P), "a") for _ in range(3)]
    handles.append(svc.submit(poison, "a"))
    snap = obs.snapshot()
    status = {r[0]: r[4] for r in snap["requests"]}
    assert isinstance(handles[3].outcome, ServeFailure)
    assert status == {0: "served", 1: "served", 2: "served", 3: "failed"}
    assert [s[0] for s in snap["spans"] if s[3] == -1][-2:] == [
        "serve.batch", "serve.isolate"]
    assert snap["counters"]["serve.batch_live"] == 3


def test_lane_and_batch_counters_match_the_batches():
    svc, handles = _serve(trace=True)
    snap = obs.snapshot()
    c = snap["counters"]
    d_b = [len(b["designs"]) for b in svc.buckets()]
    batches = [s[4] for s in snap["spans"] if s[0] == "serve.batch"]
    assert c["serve.lanes_fired"] == sum(
        svc.batch_size * d_b[b] for b, _, _ in batches)
    assert c["serve.batch_slots"] == svc.batch_size * len(batches)
    assert c["serve.batch_live"] == len(handles)
    assert sum(n for _, n, _ in batches) == len(handles)


@pytest.mark.parametrize("lowering", ["reference", "cuda"])
def test_assign_chunks_count_the_fire_loop(monkeypatch, lowering):
    """``assign.chunks`` is ceil(N / chunk) on the float-weight path, the
    number of dense fires its loop makes; one on the kernel's path."""
    fires = []
    fire = fused_column.fire_dense_ref
    monkeypatch.setattr(fused_column, "fire_chunk", lambda *dims: 3)
    monkeypatch.setattr(fused_column, "fire_dense_ref",
                        lambda *a, **k: fires.append(1) or fire(*a, **k))
    rng = np.random.default_rng(4)
    d, n, q = 2, 10, 4
    w = torch.from_numpy(rng.integers(0, 8, (d, P, q)).astype(np.float32))
    if lowering == "reference":
        w = w + 0.25
    xs = torch.from_numpy(rng.integers(0, T_MAX + 1, (n, d, P)).astype(
        np.int32))
    obs.enable()
    fused_column.assign_padded(w, xs, [20.0, 25.0], [T_MAX, T_MAX], [q, 3],
                               t_window=T_MAX, response="rnl",
                               lowering=lowering, w_max=7)
    c = obs.snapshot()["counters"]
    assert len(fires) == math.ceil(n / 3)
    assert c["assign.chunks"] == (len(fires) if lowering == "reference"
                                  else 1)


def test_sweep_volume_counters_are_the_padding_arithmetic():
    _sweep_out(trace=True)
    c = obs.snapshot()["counters"]
    (a, b) = SWEEP
    assert c["sweep.volume_live"] == P * a.q * a.t_max + P * b.q * b.t_max
    assert c["sweep.volume_padded"] == 2 * P * max(a.q, b.q) * max(
        a.t_max, b.t_max)
    spans = obs.snapshot()["spans"]
    assert [s[4] for s in spans if s[0] == "sweep.bucket"] == [
        (0, 2, (P, b.q, b.t_max))]


def test_marks_time_straight_line_stages():
    """``now``/``mark`` chain stages without a ``with`` block: each mark
    ends its stage where the next begins, under the open span; with
    tracing off they read nothing and return 0.0."""
    assert obs.now() == 0.0 and obs.mark("x", 1.0) == 0.0
    obs.enable()
    with obs.span("outer"):
        t = obs.now()
        t = obs.mark("a", t, (1,))
        t_end = obs.mark("b", t)
    spans = obs.snapshot()["spans"]
    assert [(s[0], s[3], s[4]) for s in spans] == [
        ("outer", -1, ()), ("a", 0, (1,)), ("b", 0, ())]
    assert spans[1][2] == spans[2][1] and spans[2][2] == t_end
    assert spans[0][1] <= spans[1][1] and t_end <= spans[0][2]


def test_stage_steps_are_the_monitors_own():
    """The service times its stages into its monitor's own step count:
    a shared monitor's steps run on from where they were, through the
    service's stages and the monitor's own start/stop."""
    from repro_torch.distributed.straggler import StepMonitor

    mon = StepMonitor(threshold=0.0, warmup=1)  # every step after the first
    for _ in range(3):
        mon.observe_next(1e-6, "before")
    rng = np.random.default_rng(2)
    weights = {n: rng.integers(0, 8, (c.p, c.q)).astype(np.float32)
               for n, c in FLEET.items()}
    svc = ClusteringService(FLEET, batch_size=4, refit_every=4,
                            refit_window=4, weights=weights, device="cpu",
                            monitor=mon)
    svc.warmup()
    for i in range(12):
        svc.submit(rng.normal(size=P), "a")
    mon.start("after")
    mon.stop()
    steps = [e.step for e in mon.events]
    assert steps == list(range(2, 2 + len(steps)))
    labels = [e.label for e in mon.events]
    assert labels[:2] == ["before", "before"] and labels[-1] == "after"
    assert {"assign", "refit"} <= set(labels)


def test_records_leave_the_collectors_lists():
    """Spans and request records are tuples of atoms and of such tuples,
    which the cyclic collector stops tracking within a pass a level of
    nesting: a long traced window adds nothing to its full passes."""
    import gc

    _serve(trace=True)
    for _ in range(3):  # a span's attrs nest the request ids two deep
        gc.collect()
    snap = obs.snapshot()
    assert snap["spans"] and snap["requests"]
    assert not any(gc.is_tracked(r) for r in snap["spans"] + snap["requests"])


def test_kernel_counts_are_taken_inside_the_traced_interval():
    from repro_torch.kernels import build

    obs.enable()
    build.FIRE_BLOCK.launches += 2
    build.FUSED_BLOCK.builds += 1
    mid = obs.snapshot()["kernels"]
    obs.disable()
    build.FIRE_BLOCK.launches += 5  # after the interval: not counted
    end = obs.snapshot()["kernels"]
    build.FIRE_BLOCK.launches -= 7
    build.FUSED_BLOCK.builds -= 1
    for snap in (mid, end):
        assert snap["fire_block"] == {"launches": 2, "builds": 0, "binds": 0}
        assert snap["fused_block"] == {"launches": 0, "builds": 1, "binds": 0}
        assert set(snap) == {k.name for k in build.KERNELS}


PROBE_READINGS = {
    "tiny-dse.explore": ["assign.chunks_per_design",
                         "sweep.volume_useful_pct"],
    "tiny-grid.fit": ["single.assign_ms_per_design"],
    "tiny-grid.serve": [
        "serve.queue_wait_ms_p95.lat", "serve.exec_ms_p95.lat",
        "serve.held_ms_p95.lat", "serve.admit_us_per_request.lat",
        "serve.lanes_useful_pct.lat", "serve.batch_fill_pct.lat"],
}


@pytest.mark.parametrize("cell", sorted(PROBE_READINGS))
def test_probe_reads_its_cell_on_the_cpu(cell):
    """``tools/obs_probe.py`` runs a traced window of the benchmark's tiny
    cells on the CPU: the run stays correct and gives every reading of its
    cell, each a finite number, with no kernel built or bound."""
    import json
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "tools/obs_probe.py", "trace", "--cell", cell,
         "--seed", "2147483901", "--seconds", "1", "--tiny"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    readings = {k: v for k, v in res["readings"].items()
                if not k.startswith("_")}
    assert sorted(readings) == sorted(PROBE_READINGS[cell])
    assert all(math.isfinite(v) for v in readings.values()), readings
    assert not any(k["builds"] or k["binds"]
                   for k in res["kernels_in_window"].values())


# ------------------------------------------------------------- on the card
def _kineto_ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    return int(f()) if f is not None else int(getattr(e, what + "_us")() * 1000)


@pytest.mark.cuda
def test_program_span_holds_its_kernel_on_the_device_clock():
    """A span around one ``fire_block`` launch, ended after a synchronise,
    holds the kernel's device interval, on the conversion of host
    ``perf_counter`` to the profiler's epoch clock the benchmark uses,
    to within 50 us."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA (sm_90)")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    d, n, p, q, t = 2, 64, 270, 25, 64
    w = torch.from_numpy(rng.integers(0, 8, (d, p, q)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.integers(0, t + 1, (d, n, p)).astype(np.int32)).to(dev)
    ops = fused_column.design_operands([200.0, 250.0], [t, t], [q, q],
                                       0.0, 0.0, 0.0, device=dev)
    fused_column.fire_block_padded(w, xs, ops, t_window=t, w_max=7)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        epoch_minus_perf = time.time_ns() - time.perf_counter_ns()
        obs.enable()
        with obs.span("clock.check"):
            fused_column.fire_block_padded(w, xs, ops, t_window=t, w_max=7)
            torch.cuda.synchronize(dev)
        obs.disable()
    (_, t0, t1, _, _), = obs.snapshot()["spans"]
    lo = int(t0 * 1e9) + epoch_minus_perf
    hi = int(t1 * 1e9) + epoch_minus_perf
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(_kineto_ns(e, "start"), _kineto_ns(e, "duration"))
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and "fire_block" in e.name()]
    assert len(kernels) == 1
    s, dur = kernels[0]
    early, late = lo - s, (s + dur) - hi
    print(f"clock check: kernel starts {(s - lo) / 1e3:.3f} us after the "
          f"span opens and ends {(hi - s - dur) / 1e3:.3f} us before it "
          f"closes ({dur / 1e3:.3f} us long)")
    assert early <= 50_000 and late <= 50_000
