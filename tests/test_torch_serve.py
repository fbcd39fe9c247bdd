"""The port's streaming clustering service against the JAX package's.

The same fleets, initial weights (numpy-seeded, injected into both with
``weights=``) and request streams go through
``repro.serve.ClusteringService`` and ``repro_torch.serve``'s on the CPU:

* served ids are equal, request by request; weights after online re-fits
  are bit-equal for integer mus without stabilizer, and within the
  reference's cross-lowering bound (``rtol=atol=1e-6``) on the float
  stabilizer path;
* the port's re-fit equals an offline ``fit_scan_padded`` resume, ragged
  windows included; a poisoned request is quarantined alone; a NaN re-fit
  is never committed; the watchdog discards a stalled re-fit; degraded
  mode follows ``refit_backoff``'s schedule as the JAX service does;
* admission sheds (overload, deadline, draining) as the JAX service does;
* the launches per batch and per re-fit are pinned (the port's
  counterpart of the JAX package's compile-free steady state), here on
  the CPU with the kernels' plain versions behind counting wrappers (on
  the card with the kernels' own counters: ``test_torch_cuda_kernels.py``);
* the port's copies of the checkpointer and of the fault harness behave
  as the JAX package's.
"""
from __future__ import annotations

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import simulator as jsim
from repro.core import types as jtypes
from repro.distributed import checkpoint as jckpt
from repro.kernels import fused_column as jfc
from repro.serve import ClusteringService as JService
from repro.testing import faults as jfaults
from repro_torch.core import backend, encoding, simulator
from repro_torch.core import types as ttypes
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.kernels import build, fused_column, rnl_response, stdp_update
from repro_torch.serve import (
    ClusteringService,
    RequestRejected,
    ServeFailure,
    ServeResult,
    ServeShed,
)
from repro_torch.testing import faults

P, T_MAX = 12, 16
GRID_STDP = dict(mu_capture=1.0, mu_backoff=1.0, mu_search=1.0,
                 stabilizer="none")


def _cfg(types, sim, q=4, t_max=T_MAX, grid=False):
    stdp = types.STDPConfig(**GRID_STDP) if grid else types.STDPConfig()
    c = types.ColumnConfig(p=P, q=q, t_max=t_max, stdp=stdp)
    return c.with_threshold(sim.suggest_threshold(c))


def _fleet(types, sim, n=4, grid=False) -> dict:
    return {
        f"d{i}": _cfg(types, sim, q=3 + (i % 2),
                      t_max=T_MAX * (1 + (i // 2) % 2), grid=grid)
        for i in range(n)
    }


def _fleets(n=4, grid=False):
    return _fleet(jtypes, jsim, n, grid), _fleet(ttypes, simulator, n, grid)


def _weights(fleet, seed, grid=False) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, c in fleet.items():
        w = (rng.integers(0, c.neuron.w_max + 1, (c.p, c.q)) if grid
             else rng.uniform(0, c.neuron.w_max, (c.p, c.q)))
        out[name] = w.astype(np.float32)
    return out


def _stream(rng, n):
    return [rng.normal(size=P) for _ in range(n)]


def _encode(s, t_max):
    return encoding.encode(torch.as_tensor(s, dtype=torch.float32), t_max).numpy()


def _service(fleet, **kw):
    return ClusteringService(fleet, device="cpu", **kw)


def _offline_refit(w0, enc, cfg, v_blk):
    """The port's offline resume: one ``fit_scan_padded`` over ``enc``."""
    return fused_column.fit_scan_padded(
        torch.from_numpy(w0[None]), torch.from_numpy(enc[:, None, :]),
        [cfg.neuron.threshold], [cfg.t_max], [cfg.q],
        t_window=cfg.t_max, w_max=cfg.neuron.w_max, wta_k=cfg.wta.k,
        mu_capture=cfg.stdp.mu_capture, mu_backoff=cfg.stdp.mu_backoff,
        mu_search=cfg.stdp.mu_search,
        stabilize=cfg.stdp.stabilizer == "half",
        response=cfg.neuron.response, epochs=1, lowering="reference",
        v_blk=v_blk,
    )[0].numpy()


def _assert_weights(a, b, grid):
    if grid:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- parity with JAX
@pytest.mark.parametrize("grid", [True, False], ids=["grid", "stabilizer"])
def test_ids_and_refit_weights_match_jax_service(grid):
    """Two buckets, full and partial batches, three re-fits per bucket:
    every id equal to the JAX service's, the weights bit-equal on the
    integer grid and within 1e-6 on the float stabilizer path."""
    jf, tf = _fleets(4, grid)
    kw = dict(batch_size=4, refit_every=8, refit_window=8, waste_cap=2.0,
              weights=_weights(tf, 1, grid))
    js, ts = JService(jf, **kw), _service(tf, **kw)
    js.warmup()
    ts.warmup()
    assert [b["designs"] for b in ts.buckets()] == [
        b["designs"] for b in js.buckets()]
    rng = np.random.default_rng(2)
    stream = [(s, f"d{k % 4}") for k, s in enumerate(_stream(rng, 50))]
    jh = [js.submit(s, d) for s, d in stream]
    th = [ts.submit(s, d) for s, d in stream]
    js.flush()
    ts.flush()
    assert [h.result().cluster for h in th] == [h.result().cluster for h in jh]
    jst, tst = js.stats(), ts.stats()
    for field in ("served", "batches", "refits", "failed", "isolations"):
        assert getattr(tst, field) == getattr(jst, field), field
    assert tst.refits >= 4
    for d in tf:
        _assert_weights(ts.weights(d), np.asarray(js.weights(d)), grid)


def test_serves_full_and_partial_batches():
    _, tf = _fleets(2)
    service = _service(tf, batch_size=4, refit_every=0)
    service.warmup()
    rng = np.random.default_rng(0)
    handles = [service.submit(s, f"d{i % 2}")
               for i, s in enumerate(_stream(rng, 6))]
    assert [h.done for h in handles] == [True] * 4 + [False] * 2
    assert service.stats().pending == 2
    res = handles[-1].result()
    assert isinstance(res, ServeResult)
    assert all(h.done for h in handles)
    stats = service.stats()
    assert stats.served == 6 and stats.pending == 0 and not stats.failed
    for h in handles:
        r = h.result()
        assert 0 <= r.cluster <= service._cfgs[r.design].q
        assert r.latency_s >= 0


def test_results_match_single_design_assignment_entry():
    """Bucket-batched serving answers == the D = 1 assignment entry on the
    design's own envelope, request by request, in both packages."""
    jf, tf = _fleets(4)
    service = _service(tf, batch_size=4, refit_every=0, seed=3,
                       waste_cap=2.0)
    service.warmup()
    assert len(service.buckets()) >= 2
    rng = np.random.default_rng(1)
    names = service.designs()
    cases = [(s, names[i % 4]) for i, s in enumerate(_stream(rng, 12))]
    handles = [service.submit(s, d) for s, d in cases]
    service.flush()
    for h, (s, d) in zip(handles, cases):
        w = service.weights(d)
        expect = simulator.assign_time_series(s, tf[d], {"w": w}, device="cpu")
        assert h.result().cluster == int(expect)
        assert int(expect) == int(jsim.assign_time_series(s, jf[d], {"w": w}))


def test_seed_drawn_weights_are_the_ports_own():
    """Without ``weights=`` each design draws ``column.init_params`` from
    a generator seeded by (seed, index): reproducible, seed-dependent,
    uniform over [0, w_max]."""
    _, tf = _fleets(2)
    a = _service(tf, seed=5)
    b = _service(tf, seed=5)
    c = _service(tf, seed=6)
    for d in tf:
        np.testing.assert_array_equal(a.weights(d), b.weights(d))
        assert not np.array_equal(a.weights(d), c.weights(d))
        assert a.weights(d).min() >= 0 and a.weights(d).max() <= 7


# -------------------------------------------------------------- re-fit
@pytest.mark.parametrize("n_live", [8, 6], ids=["full", "ragged"])
def test_online_refit_matches_offline_resume(n_live):
    """Live re-fit == offline ``fit_scan_padded`` resume from the same
    weights on the same volleys; a ragged window (6 live volleys of 8)
    == the resume on the 6 volleys alone (silent rows are no-ops); and
    both == the JAX package's ``backend.fit_padded``."""
    jcfg, cfg = _cfg(jtypes, jsim), _cfg(ttypes, simulator)
    w0 = _weights({"d0": cfg}, 7)["d0"]
    service = _service({"d0": cfg}, batch_size=2, refit_every=n_live,
                       refit_window=8, weights={"d0": w0})
    service.warmup()
    np.testing.assert_array_equal(service.weights("d0"), w0)
    series = _stream(np.random.default_rng(3), n_live)
    for s in series:
        service.submit(s, "d0")
    assert service.stats().refits == 1
    enc = np.stack([_encode(s, cfg.t_max) for s in series])
    for v_blk in (1, 3, n_live):
        np.testing.assert_array_equal(
            service.weights("d0"), _offline_refit(w0, enc, cfg, v_blk))
    w_jax = jbackend.fit_padded(
        jnp.asarray(w0[None]), jnp.asarray(enc[:, None, :], jtypes.TIME_DTYPE),
        jnp.asarray([jcfg.neuron.threshold], jnp.float32),
        jnp.asarray([jcfg.t_max], jtypes.TIME_DTYPE),
        jnp.asarray([jcfg.q], jtypes.TIME_DTYPE),
        t_window=jcfg.t_max, w_max=jcfg.neuron.w_max, wta_k=jcfg.wta.k,
        mu_capture=jcfg.stdp.mu_capture, mu_backoff=jcfg.stdp.mu_backoff,
        mu_search=jcfg.stdp.mu_search, stabilize=True,
        response=jcfg.neuron.response, epochs=1, lowering="reference",
    )
    np.testing.assert_allclose(service.weights("d0"), np.asarray(w_jax[0]),
                               rtol=1e-6, atol=1e-6)


def test_refit_actually_learns():
    _, tf = _fleets(1)
    service = _service(tf, batch_size=4, refit_every=4, refit_window=4,
                       seed=2)
    service.warmup()
    w0 = service.weights("d0")
    rng = np.random.default_rng(9)
    for s in _stream(rng, 4):
        service.submit(s, "d0")
    assert service.stats().refits == 1
    assert not np.array_equal(service.weights("d0"), w0)
    h = service.submit(rng.normal(size=P), "d0")
    assert isinstance(h.result(), ServeResult)


def test_weights_returns_a_copy():
    _, tf = _fleets(1)
    service = _service(tf)
    w = service.weights("d0")
    w[:] = -1
    assert service.weights("d0").min() >= 0


# ----------------------------------------------------------- admission
def test_structured_rejection_before_device_work(monkeypatch):
    """Admission failures raise structured RequestRejected before any
    entry point runs, with the JAX service's reasons and counters."""
    _, tf = _fleets(2)
    service = _service(tf, batch_size=4, refit_every=0)
    service.warmup()
    monkeypatch.setattr(fused_column, "assign_padded",
                        faults.fail_always(detail="no device work expected"))
    cases = [
        (np.zeros(P + 3), "d0", "envelope"),
        (np.zeros(P), "nope", "unknown-design"),
        (np.zeros((2, P)), "d0", "shape"),
        (np.full(P, np.nan), "d0", "non-finite"),
    ]
    for series, design, reason in cases:
        with pytest.raises(RequestRejected) as ei:
            service.submit(series, design)
        assert ei.value.reason == reason
        assert ei.value.detail
    stats = service.stats()
    assert stats.rejected == len(cases)
    assert stats.rejections == {
        "envelope": 1, "unknown-design": 1, "shape": 1, "non-finite": 1,
    }
    assert stats.offered == len(cases) and stats.submitted == 0
    monkeypatch.undo()
    h = service.submit(np.random.default_rng(0).normal(size=P), "d0")
    assert isinstance(h.result(), ServeResult)


def test_rejects_incompatible_fleets_at_construction():
    import dataclasses

    with pytest.raises(ValueError, match="threshold"):
        _service({"bad": ttypes.ColumnConfig(p=P, q=4, t_max=T_MAX)
                  .with_threshold(0.0)})
    a = _cfg(ttypes, simulator)
    b = dataclasses.replace(
        a, neuron=dataclasses.replace(a.neuron, w_max=a.neuron.w_max + 1)
    )
    with pytest.raises(ValueError, match="statics"):
        _service({"a": a, "b": b})
    with pytest.raises(ValueError, match="at least one design"):
        _service({})
    with pytest.raises(ValueError, match="encoder"):
        _service({"a": a}, encoder="morse")
    with pytest.raises(ValueError, match="weights"):
        _service({"a": a}, weights={"a": np.zeros((P + 1, 4))})


def test_overload_sheds_structured_with_retry_hint():
    _, tf = _fleets(2)
    service = _service(tf, batch_size=8, refit_every=0, max_pending=3)
    service.warmup()
    rng = np.random.default_rng(0)
    for _ in range(3):
        service.submit(rng.normal(size=P), "d0")
    with pytest.raises(RequestRejected) as ei:
        service.submit(rng.normal(size=P), "d0")
    assert ei.value.reason == "overloaded"
    assert ei.value.retry_after_s is not None
    service.flush()
    h = service.submit(rng.normal(size=P), "d0")
    assert isinstance(h.result(), ServeResult)
    stats = service.stats()
    assert stats.rejections == {"overloaded": 1}
    assert stats.offered == 5 and stats.submitted == 4 and stats.served == 4


def test_deadline_budget_sheds_at_dispatch_and_admission():
    _, tf = _fleets(2)
    service = _service(tf, batch_size=4, refit_every=0)
    service.warmup()
    rng = np.random.default_rng(1)
    h = service.submit(rng.normal(size=P), "d0", deadline_s=0.005)
    time.sleep(0.02)
    service.flush()
    shed = h.result()
    assert isinstance(shed, ServeShed)
    assert shed.reason == "deadline" and shed.waited_s >= 0.005
    for _ in range(4):
        service.submit(rng.normal(size=P), "d0")
    assert service._batch_ewma is not None
    with pytest.raises(RequestRejected) as ei:
        service.submit(rng.normal(size=P), "d0", deadline_s=1e-12)
    assert ei.value.reason == "deadline"
    assert ei.value.retry_after_s > 0
    stats = service.stats()
    assert stats.shed == 1 and stats.rejections == {"deadline": 1}
    assert stats.served == 4 and not stats.failed


def test_drain_serves_inflight_then_stops_admission():
    _, tf = _fleets(2)
    service = _service(tf, batch_size=4, refit_every=0)
    service.warmup()
    rng = np.random.default_rng(2)
    handles = [service.submit(rng.normal(size=P), "d0") for _ in range(2)]
    assert not any(h.done for h in handles)
    service.drain()
    assert all(isinstance(h.result(), ServeResult) for h in handles)
    with pytest.raises(RequestRejected) as ei:
        service.submit(rng.normal(size=P), "d0")
    assert ei.value.reason == "draining"
    stats = service.stats()
    assert stats.served == 2 and stats.pending == 0
    assert stats.rejections == {"draining": 1}


# ------------------------------------------------------------ quarantine
def test_poisoned_request_quarantines_alone(monkeypatch):
    """A request that detonates the batch fails ALONE: every batch-mate
    re-runs through the same entry point and answers bit-identically to
    the unpoisoned assignment, in the port and in the JAX package."""
    jcfg, cfg = _cfg(jtypes, jsim), _cfg(ttypes, simulator)
    w = _weights({"d0": cfg}, 4)["d0"]
    service = _service({"d0": cfg}, batch_size=4, refit_every=0,
                       weights={"d0": w})
    service.warmup()
    clean = _stream(np.random.default_rng(7), 3)
    expect = [int(simulator.assign_time_series(s, cfg, {"w": w}, device="cpu"))
              for s in clean]
    assert expect == [int(jsim.assign_time_series(s, jcfg, {"w": w}))
                      for s in clean]
    poison = np.full(P, 2.5)
    monkeypatch.setattr(
        fused_column, "assign_padded",
        faults.fail_on_volley(fused_column.assign_padded,
                              _encode(poison, cfg.t_max)),
    )
    handles = [service.submit(s, "d0") for s in clean]
    handles.append(service.submit(poison, "d0"))
    outcomes = [h.result() for h in handles]
    for got, want in zip(outcomes[:3], expect):
        assert isinstance(got, ServeResult)
        assert got.cluster == want
    assert isinstance(outcomes[3], ServeFailure)
    assert outcomes[3].stage == "assign"
    assert "poisoned" in outcomes[3].error
    stats = service.stats()
    assert stats.failed == 1 and stats.isolations == 1
    assert stats.served == 3 and stats.pending == 0


# ------------------------------------------------------- degraded re-fit
def test_refit_backoff_matches_jax():
    assert backend.REFIT_BACKOFF_CAP == jbackend.REFIT_BACKOFF_CAP
    for k in range(0, 14):
        assert backend.refit_backoff(k) == jbackend.refit_backoff(k)


def test_refit_outage_degrades_and_recovers_as_the_jax_service(monkeypatch):
    """With the re-fit entry point down, both services answer every
    request from last-good weights, sit out the same windows
    (``refit_backoff``), and recover at the same window once the fault
    lifts, with equal ids and weights."""
    jf, tf = _fleets(2, grid=True)
    kw = dict(batch_size=4, refit_every=4, refit_window=4,
              weights=_weights(tf, 8, grid=True))
    js, ts = JService(jf, **kw), _service(tf, **kw)
    js.warmup()
    ts.warmup()
    w0 = {d: ts.weights(d) for d in tf}
    rng = np.random.default_rng(3)
    phase1 = [(rng.normal(size=P), f"d{k % 2}") for k in range(24)]
    phase2 = [(rng.normal(size=P), f"d{k % 2}") for k in range(32)]
    out = {}
    for name, svc, mod, fmod in (("jax", js, jfc, jfaults),
                                 ("port", ts, fused_column, faults)):
        with monkeypatch.context() as m:
            m.setattr(mod, "fit_scan_padded",
                      fmod.fail_always(detail="refit down"))
            h1 = [svc.submit(s, d) for s, d in phase1]
            svc.flush()
        mid = svc.stats()
        w_mid = {d: np.asarray(svc.weights(d)) for d in tf}
        h2 = [svc.submit(s, d) for s, d in phase2]
        svc.flush()
        out[name] = (mid, svc.stats(), [h.result().cluster for h in h1 + h2])
        if name == "port":
            for d in tf:  # last-good weights held through the outage
                np.testing.assert_array_equal(w_mid[d], w0[d])
    (jmid, jend, jids), (tmid, tend, tids) = out["jax"], out["port"]
    assert tmid.served == 24 and not tmid.failed
    assert tmid.degraded == 1 and tmid.refit_failures >= 1 and tmid.refits == 0
    for field in ("refit_failures", "refits", "recoveries", "degraded"):
        assert getattr(tmid, field) == getattr(jmid, field), field
        assert getattr(tend, field) == getattr(jend, field), field
    assert tend.recoveries == 1 and tend.degraded == 0 and tend.refits >= 1
    assert tids == jids
    for d in tf:
        np.testing.assert_array_equal(ts.weights(d), np.asarray(js.weights(d)))


def test_degraded_bucket_sits_out_the_backoff_schedule(monkeypatch):
    """After the k-th consecutive failure the bucket skips exactly
    ``refit_backoff(k)`` windows before its next attempt."""
    _, tf = _fleets(1)
    service = _service(tf, batch_size=1, refit_every=1, refit_window=1,
                       refit_budget_s=None)
    attempts = []

    def failing(*a, **k):
        attempts.append(service.stats().served)
        raise faults.InjectedFault("injected fault: down")

    monkeypatch.setattr(fused_column, "fit_scan_padded", failing)
    rng = np.random.default_rng(0)
    for _ in range(1 + 1 + 1 + 2 + 1 + 4 + 1):
        service.submit(rng.normal(size=P), "d0")
    # after failure k the bucket skips refit_backoff(k) = 1, 2, 4 windows
    assert attempts == [1, 3, 6, 11]
    assert service._buckets[0].cooldown == backend.refit_backoff(4) == 8
    assert service.stats().refit_failures == 4 and service.stats().degraded == 1


def test_nan_poisoned_refit_is_never_committed(monkeypatch):
    _, tf = _fleets(1)
    service = _service(tf, batch_size=4, refit_every=4, refit_window=4,
                       seed=1)
    service.warmup()
    w0 = service.weights("d0")
    rng = np.random.default_rng(4)
    with monkeypatch.context() as m:
        m.setattr(fused_column, "fit_scan_padded",
                  faults.nan_poison(fused_column.fit_scan_padded))
        for s in _stream(rng, 4):
            service.submit(s, "d0")
    stats = service.stats()
    assert stats.refit_failures == 1 and stats.degraded == 1
    assert stats.refits == 0 and not stats.failed
    assert np.array_equal(service.weights("d0"), w0)
    assert np.isfinite(service.weights("d0")).all()


def test_refit_watchdog_discards_stalled_attempt(monkeypatch):
    _, tf = _fleets(1)
    service = _service(tf, batch_size=4, refit_every=4, refit_window=4,
                       seed=2, refit_budget_s=0.01)
    service.warmup()
    w0 = service.weights("d0")
    rng = np.random.default_rng(5)
    with monkeypatch.context() as m:
        m.setattr(fused_column, "fit_scan_padded",
                  faults.slow_call(fused_column.fit_scan_padded, 0.05))
        for s in _stream(rng, 4):
            service.submit(s, "d0")
    stats = service.stats()
    assert stats.refit_stalls >= 1 and stats.refit_failures == 1
    assert stats.degraded == 1 and not stats.failed
    assert np.array_equal(service.weights("d0"), w0)


# ------------------------------------------------------------ launches
def _count_launches(monkeypatch):
    """On the CPU: the lowering probe says 'cuda', and the two kernels'
    wrappers become counting wrappers over their plain versions; the
    other kernels' wrappers raise if the serving path reaches them."""
    counts = {"fire_block": 0, "fused_block": 0}

    def fire(w, xs, ops, **kw):
        assert xs.dtype == torch.int32  # the path's volleys, uncast
        counts["fire_block"] += 1
        return fused_column.fire_block_padded_plain(w, xs, ops, **kw)

    def block(w, blk, ops, nv, **kw):
        counts["fused_block"] += 1
        return fused_column.fused_block_padded_plain(w, blk, ops, nv,
                                                     response="rnl", **kw)

    monkeypatch.setattr(backend, "lowering", lambda t: "cuda")
    monkeypatch.setattr(fused_column, "fire_block_padded", fire)
    monkeypatch.setattr(fused_column, "fused_block_padded", block)
    for mod, name in ((fused_column, "fused_fit_padded"),
                      (fused_column, "fused_step_padded"),
                      (rnl_response, "rnl_fire"), (stdp_update, "stdp_update"),
                      (build, "build_all")):
        monkeypatch.setattr(mod, name, faults.fail_always(detail=name))
    return counts


@pytest.mark.parametrize("epochs", [1, 2])
def test_launches_per_batch_and_per_refit_are_pinned(monkeypatch, epochs):
    """The port's counterpart of the compile-free steady state: after
    ``warmup``, each batch on integer-grid weights is ONE fire_block
    launch, each re-fit is epochs x (window / v_blk) fused_block launches,
    and nothing else is launched or built."""
    counts = _count_launches(monkeypatch)
    _, tf = _fleets(4, grid=True)
    service = _service(tf, batch_size=8, refit_every=16, refit_window=16,
                       refit_epochs=epochs, waste_cap=2.0,
                       weights=_weights(tf, 6, grid=True))
    assert all(b.asg_lowering == "cuda" and b.fit_lowering == "cuda"
               for b in service._buckets)
    service.warmup()
    assert counts == {"fire_block": 2, "fused_block": 2 * epochs}
    counts.update(fire_block=0, fused_block=0)
    rng = np.random.default_rng(2)
    names = service.designs()
    for _ in range(3):
        for s in range(24):
            service.submit(rng.normal(size=P), names[s % len(names)])
        service.flush()
    stats = service.stats()
    assert stats.served == 72 and not stats.failed and stats.refits >= 2
    assert all(b.asg_lowering == "cuda" for b in service._buckets)
    v_blk = backend.execution_plan("fit", "cuda", 2, 16).v_blk
    assert v_blk == 16
    assert counts["fire_block"] == stats.batches
    assert counts["fused_block"] == stats.refits * epochs * (16 // v_blk)


# ------------------------------------------------- seams used by serving
def test_pad_stream_silent_seam():
    xs = torch.arange(12, dtype=torch.int32).reshape(2, 2, 3)
    out = fused_column.pad_stream_silent(xs, 5, 99)
    assert out.shape == (5, 2, 3) and out.dtype == torch.int32
    assert torch.equal(out[:2], xs) and bool((out[2:] == 99).all())
    with pytest.raises(ValueError, match="exceeds"):
        fused_column.pad_stream_silent(xs, 1, 99)
    j = jfc.pad_stream_silent(xs.numpy(), 5, 99)
    np.testing.assert_array_equal(out.numpy(), j)


# ------------------------------------------------------------- harness
def _raises(fn, *args) -> bool:
    try:
        fn(*args)
    except RuntimeError as e:
        assert "injected fault" in str(e)
        return True
    return False


@pytest.mark.parametrize("make, arg", [
    ("fail_on_threshold", 2.0), ("fail_on_threshold", 3.0),
    ("fail_on_volley", (3, 4, 5)), ("fail_on_volley", (3, 4, 6)),
])
def test_fault_injectors_behave_as_the_jax_ones(make, arg):
    """The port's per-design and per-request poisons raise where the JAX
    package's do, on host inputs and on tensors alike."""
    def orig(w, xs, thresholds, *a, **k):
        return torch.zeros(2)

    xs = np.arange(12, dtype=np.int32).reshape(2, 2, 3)
    thr = [1.0, 2.0]
    want = _raises(getattr(jfaults, make)(orig, np.asarray(arg)), None, xs, thr)
    assert want == (arg in (2.0, (3, 4, 5)))
    t = getattr(faults, make)(orig, np.asarray(arg))
    assert _raises(t, None, xs, thr) == want
    assert _raises(t, None, torch.from_numpy(xs), torch.tensor(thr)) == want


def test_fault_harness_defaults_and_wrappers():
    low = faults.fail_on_lowering(lambda *a, **k: 1)
    with pytest.raises(faults.InjectedFault, match="'cuda'"):
        low(lowering="cuda")
    assert low(lowering="reference") == 1
    out = faults.nan_poison(lambda: torch.ones(2, 2))()
    assert isinstance(out, torch.Tensor) and int(torch.isnan(out).sum()) == 1
    t0 = time.perf_counter()
    assert faults.slow_call(lambda: 1, 0.02)() == 1
    assert time.perf_counter() - t0 >= 0.02
    with pytest.raises(faults.InjectedFault, match="down"):
        faults.fail_always(detail="down")()


def test_injected_context_manager_installs_and_restores():
    orig = fused_column.fit_scan_padded
    with faults.injected("fit_scan_padded", faults.fail_always,
                         detail="down") as o:
        assert o is orig and fused_column.fit_scan_padded is not orig
        with pytest.raises(faults.InjectedFault, match="injected fault"):
            fused_column.fit_scan_padded()
    assert fused_column.fit_scan_padded is orig


# ---------------------------------------------------------- checkpoint
def _tree(rng):
    return {"b": [rng.normal(size=(2, 3)).astype(np.float32),
                  rng.integers(0, 9, (4,)).astype(np.int32)],
            "a": {"w": rng.normal(size=(3, 2, 2)).astype(np.float32)}}


def test_checkpoint_reads_and_writes_the_jax_layout(tmp_path):
    """A directory the JAX checkpointer wrote restores in the port and the
    other way round: same leaf order, names, dtypes and values."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    jc = jckpt.Checkpointer(str(tmp_path / "j"))
    jc.save(3, tree, blocking=True)
    tc = tckpt.Checkpointer(str(tmp_path / "j"))
    got, step = tc.restore(tree)
    assert step == 3
    np.testing.assert_array_equal(got["a"]["w"], tree["a"]["w"])
    np.testing.assert_array_equal(got["b"][1], tree["b"][1])
    ttree = {"b": [torch.from_numpy(tree["b"][0]), torch.from_numpy(tree["b"][1])],
             "a": {"w": torch.from_numpy(tree["a"]["w"])}}
    tc2 = tckpt.Checkpointer(str(tmp_path / "t"))
    tc2.save(5, ttree, blocking=True)
    jgot, jstep = jckpt.Checkpointer(str(tmp_path / "t")).restore(tree)
    assert jstep == 5
    for x, y in zip(jckpt._flatten(jgot)[0], jckpt._flatten(tree)[0]):
        np.testing.assert_array_equal(np.asarray(x), y)
    mj = json.loads((tmp_path / "j" / "step_3" / "manifest.json").read_text())
    mt = json.loads((tmp_path / "t" / "step_5" / "manifest.json").read_text())
    assert mj["names"] == mt["names"] == ["a/w", "b/0", "b/1"]
    assert mj["dtypes"] == mt["dtypes"] and mj["shapes"] == mt["shapes"]


def test_checkpoint_copies_to_host_before_the_writer_starts(tmp_path):
    """``save`` takes the leaves' values at the call: changing a tensor
    right after an asynchronous save does not reach the snapshot; restore
    onto a named device gives tensors there."""
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ck = tckpt.Checkpointer(str(tmp_path))
    ck.save(1, [w])
    w.add_(100)
    ck.wait()
    (host,), _ = ck.restore([w])
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, np.arange(6).reshape(2, 3))
    (dev,), _ = ck.restore([w], device="cpu")
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    ck.save(2, [w], blocking=True)
    ck.save(3, [w], blocking=True)
    assert ck.steps() == [1, 2, 3] and ck.latest_step() == 3
    ck.prune(keep=2)
    assert ck.steps() == [2, 3]
    with pytest.raises(ValueError, match="leaves"):
        ck.restore([w, w])
    with pytest.raises(ValueError, match="shape"):
        ck.restore([torch.zeros(3, 2)])
