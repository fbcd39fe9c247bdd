"""The plain reference against the port's CPU path on small cases: the
same inputs give the same weights, times, ids and scores, bit for bit."""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from nspubench import data
from nspubench.reference import explore as rx
from nspubench.reference import fit as rf
from nspubench.reference import serve as rs
from nspubench.reference import tnn

DEFAULT = tnn.Rule(0.5, 0.5, 1 / 1024, True)
GRID = tnn.Rule(1.0, 1.0, 1.0, False)


def _padded_case(rng, integer: bool):
    d, p, q = 3, 40, 6
    tms, qas, thrs = [32, 16, 32], [6, 4, 5], [30.0, 20.5, 44.0]
    if integer:
        w0 = rng.integers(0, 8, (d, p, q)).astype(np.float32)
    else:
        w0 = rng.uniform(0, 7, (d, p, q)).astype(np.float32)
    xs = rng.integers(0, 34, (20, d, p)).astype(np.int32)
    for k in range(d):
        xs[:, k] = np.minimum(xs[:, k], tms[k])
    return torch.from_numpy(w0), torch.from_numpy(xs), tms, qas, thrs


@pytest.mark.parametrize("rule", [DEFAULT, GRID], ids=["stabilized", "integer-grid"])
def test_fold_and_assignment_equal_the_padded_port(rule):
    from repro_torch.kernels import fused_column as fc

    w0, xs, tms, qas, thrs = _padded_case(np.random.default_rng(0), not rule.stabilize)
    want = fc.fit_scan_padded(
        w0, xs, thrs, tms, qas, t_window=32, w_max=7, wta_k=1,
        mu_capture=rule.mu_capture, mu_backoff=rule.mu_backoff,
        mu_search=rule.mu_search, stabilize=rule.stabilize, response="rnl",
        epochs=2, lowering="reference", v_blk=8)
    ds = tnn.Designs.of(thrs, tms, qas, [40] * 3, "cpu")
    vol = xs.permute(1, 0, 2).long()
    got, _, steps = tnn.fold(w0.clone(), vol, ds, rule, 2, 32)
    assert torch.equal(got, want)
    assert steps.tolist() == [40, 40, 40]
    t, _ = tnn.fire_dense(got, vol, ds, 32)
    ids = fc.assign_padded(got, xs, thrs, tms, qas, t_window=32, response="rnl",
                           lowering="reference")
    assert torch.equal(tnn.ids_from_times(t, ds), ids.long())
    grid = torch.round(torch.clamp(got, 0, 7))
    tg, _ = tnn.fire_grid(grid, vol[:, 0], ds, 32, 7)
    td, _ = tnn.fire_dense(grid, vol[:, :1], ds, 32)
    assert torch.equal(tg, td[:, 0])


@pytest.mark.parametrize("encoder", ["latency", "onoff"])
def test_encoders_equal_the_port(encoder):
    from repro_torch.core import encoding

    x = torch.from_numpy(np.random.default_rng(1).normal(size=(12, 50)).astype(np.float32))
    assert torch.equal(tnn.encode(x, 32, encoder), encoding.encode(x, 32, encoder).long())


def test_rand_index_forecast_and_buckets_equal_the_port():
    from repro_torch.clustering.metrics import rand_index
    from repro_torch.core import backend
    from repro_torch.hwgen.forecast import PaperForecaster

    rng = np.random.default_rng(2)
    a, b = rng.integers(0, 4, 200), rng.integers(0, 6, 200)
    assert tnn.rand_index(a, b) == rand_index(a, b)
    f = PaperForecaster()
    for syn in (130, 6750, 27000):
        assert rx.area_um2(syn) == f.area_um2(syn)
        assert rx.leakage_uw(syn) == f.leakage_uw(syn)
    shapes = [(p, q, 64) for p, q in ((65, 2), (96, 2), (152, 2), (343, 2), (637, 2),
                                      (470, 5), (270, 25))]
    assert rs.envelope_buckets(shapes, 4.0) == backend.envelope_buckets(shapes, 4.0)


def _grid_cfg(name, p, q):
    from repro_torch.core.types import ColumnConfig, STDPConfig

    c = ColumnConfig(p=p, q=q, t_max=64, stdp=STDPConfig(1.0, 1.0, 1.0, "none"))
    return c.with_threshold(tnn.suggest_threshold(p, 7))


def test_fit_equals_cluster_time_series():
    from repro_torch.core import simulator

    rng = np.random.default_rng(3)
    specs = [("ECG200", 96, 2, 40), ("Beef", 120, 5, 30)]
    designs, w0 = [], []
    for name, p, q, n in specs:
        x, y = data.stream(name, 4, n, p)
        designs.append(dict(series=x, labels=y, q=q, t_max=64,
                            threshold=tnn.suggest_threshold(p, 7)))
        w0.append(torch.from_numpy(rng.integers(0, 8, (2, p, q)).astype(np.float32)))
    out = rf.fit_grid(designs, w0, 2, GRID, 64, "cpu")
    for (name, p, q, _), d, w, r in zip(specs, designs, w0, out):
        for j in range(2):
            got = simulator.cluster_time_series(d["series"], d["labels"], _grid_cfg(name, p, q),
                                                epochs=2, params={"w": w[j]}, device="cpu")
            assert torch.equal(got.params["w"], r["w"][j])
            assert np.array_equal(got.assignments, r["ids"][j])
            assert got.rand_index == r["rand_index"][j]


def test_serve_replay_equals_the_service():
    from repro_torch.serve import ClusteringService

    rng = np.random.default_rng(4)
    specs = [("SonyAIBORobotSurface2", 65, 2), ("ECG200", 96, 2), ("Beef", 470, 5)]
    data_ = {n: data.stream(n, 3, 60, p) for n, p, _ in specs}
    cfgs = {n: _grid_cfg(n, p, q) for n, p, q in specs}
    w0 = {n: rng.integers(0, 8, (p, q)).astype(np.float32) for n, p, q in specs}
    svc = ClusteringService(cfgs, batch_size=4, refit_every=8, refit_window=5,
                            refit_epochs=1, weights=w0, waste_cap=4.0, device="cpu")
    svc.warmup()
    reqs = [(int(d), int(rng.integers(0, 60))) for d in rng.integers(0, 3, 300)]
    handles = [svc.submit(data_[specs[d][0]][0][i], specs[d][0]) for d, i in reqs]
    svc.flush()
    designs = [dict(series=data_[n][0], q=q, t_max=64, threshold=cfgs[n].neuron.threshold)
               for n, _, q in specs]
    ref = rs.replay(designs, [w0[n] for n, _, _ in specs], reqs, batch_size=4,
                    refit_every=8, refit_window=5, refit_epochs=1, waste_cap=4.0,
                    rule=GRID, device="cpu")
    assert len(ref["refits"]) == svc.stats().refits > 0
    assert [h.outcome.cluster for h in handles] == ref["ids"].tolist()
    for d, (n, _, _) in enumerate(specs):
        assert np.array_equal(svc.weights(n), ref["weights"][d].numpy())


def test_explore_equals_the_port():
    from repro_torch.dse import DesignSpace

    explore = importlib.import_module("repro_torch.dse.explore")
    x, y = data.stream("WordSynonyms", 5, 40, 30)
    axes = dict(q=[3, 5], t_max=[8, 16], threshold_scale=[0.75, 1.25],
                encoder=["latency", "onoff"])
    res = explore.explore(x, y, DesignSpace(**axes), epochs=2, seed=11, device="cpu")
    job = rx.explore(x, y, axes, [11], 2, DEFAULT, "cpu")["jobs"][0]
    assert sorted(f["index"] for f in res.meta["failures"]) == job["silent"]
    assert [p.index for p in res.pareto] == job["pareto"]
    assert len(res.points) == len(job["points"])
    for p in res.points:
        want = job["points"][p.index]
        assert np.array_equal(p.params["w"], want["w"])
        assert (p.rand_index, p.area_um2, p.leakage_uw) == (
            want["rand_index"], want["area_um2"], want["leakage_uw"])
