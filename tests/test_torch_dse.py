"""Port parity, part 8: design-space exploration (``repro_torch.dse``) and
the straggler monitor it uses.

The JAX package and the port run the same inputs on the CPU.  Candidate
spaces, configs, fingerprints and Pareto frontiers must be equal.
``explore`` draws its initial weights from its own ``initial_weights``
(a ``torch.Generator``), which cannot reproduce ``jax.random``; the
parity test hands it the JAX package's weights for each (seed, index)
and then requires equal Rand index, synapses, area and leakage and
bit-equal weights for every point, and the same frontier.  No tolerance
anywhere: ids are integers, and the padded scan repeats the JAX
reference lowering's arithmetic bit for bit.  The rest holds the port's
own contract: journal resume, the refusal of a JAX package journal,
quarantine of a poisoned candidate, no silent CPU run without a card,
and the shared-memory split of a volley block that does not fit.
"""
import dataclasses
import importlib
import json

import jax
import numpy as np
import pytest
import torch

from repro import dse as jdse
from repro.core import column as jcolumn
from repro.core.types import ColumnConfig as JColumn
from repro.distributed import straggler as jstraggler
from repro_torch import dse
from repro_torch.core.types import ColumnConfig
from repro_torch.data import ucr
from repro_torch.distributed import straggler
from repro_torch.kernels import build, fused_column

# the module (the package's ``explore`` attribute is the function)
explore_mod = importlib.import_module("repro_torch.dse.explore")

SPACE = dict(q=(2, 3), t_max=(16, 32), threshold_scale=(1.0,),
             encoder=("latency", "onoff"))


def _stream(n=40):
    ds = ucr.load("SonyAIBORobotSurface2")  # L = 65; on/off p = 130
    return ds.x[:n], ds.y[:n]


def jax_initial_weights(seed, index, cfg):
    """The JAX package's explore init for candidate ``index``."""
    _, key = jax.random.split(jax.random.key(seed))
    jcfg = JColumn(p=cfg.p, q=cfg.q, t_max=cfg.t_max)
    return np.asarray(
        jcolumn.init_params(jax.random.fold_in(key, index), jcfg)["w"])


class CountingJournal(dse.Journal):
    """A journal that remembers how many records each bucket appended."""

    def __init__(self, path):
        super().__init__(path)
        self.sizes = []

    def append(self, records):
        self.sizes.append(len(records))
        super().append(records)


# ------------------------------------------------------------ the space
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_grid_and_sample_equal(seed):
    kw = dict(q=(2, 5, 9), t_max=(16, 64), threshold_scale=(0.75, 1.0, 1.25),
              encoder=("latency", "onoff"))
    space, jspace = dse.DesignSpace(**kw), jdse.DesignSpace(**kw)
    assert space.size() == jspace.size() == 36
    as_dicts = lambda cs: [dataclasses.asdict(c) for c in cs]  # noqa: E731
    assert as_dicts(space.grid()) == as_dicts(jspace.grid())
    for n in (1, 5, 36, 99):
        assert as_dicts(space.sample(n, seed)) == as_dicts(jspace.sample(n, seed))
    with pytest.raises(ValueError):
        dse.DesignSpace(q=(), t_max=(16,))
    with pytest.raises(ValueError):
        dse.DesignSpace(q=(2,), t_max=(16,), encoder=("delta",))


@pytest.mark.parametrize("series_len", [65, 270])
def test_candidate_config_and_fingerprint_equal(series_len):
    kw = dict(q=(2, 25), t_max=(32, 64), threshold_scale=(0.75, 1.25),
              encoder=("latency", "onoff"))
    for cand, jcand in zip(dse.DesignSpace(**kw).grid(),
                           jdse.DesignSpace(**kw).grid()):
        cfg = dse.candidate_config(cand, series_len)
        jcfg = jdse.candidate_config(jcand, series_len)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for seed, epochs in ((0, 4), (3, 1)):
            assert dse.candidate_fingerprint(cfg, cand.encoder, seed, epochs) == \
                jdse.candidate_fingerprint(jcfg, jcand.encoder, seed, epochs)


def test_pareto_front_equal():
    rng = np.random.default_rng(0)
    pts, jpts = [], []
    for i in range(40):
        ri = float("nan") if i % 9 == 4 else float(rng.choice([0.5, 0.6, 0.7]))
        area = float(rng.choice([100.0, 200.0, 300.0]))
        leak = float(rng.choice([1.0, 2.0]))
        common = dict(index=i, encoder="latency", rand_index=ri, synapses=i,
                      area_um2=area, leakage_uw=leak, params={})
        pts.append(dse.DesignPoint(cfg=ColumnConfig(p=4, q=2), **common))
        jpts.append(jdse.DesignPoint(cfg=JColumn(p=4, q=2), **common))
    front = [p.index for p in dse.pareto_front(pts)]
    assert front == [p.index for p in jdse.pareto_front(jpts)]
    assert front and dse.pareto_front([]) == []
    for a, ja in zip(pts[:10], jpts[:10]):
        for b, jb in zip(pts[:10], jpts[:10]):
            assert dse.dominates(a, b) == jdse.dominates(ja, jb)


# ------------------------------------------------------------ explore
def test_explore_equals_jax_with_jax_initial_weights(monkeypatch):
    x, y = _stream()
    jres = jdse.explore(x, y, jdse.DesignSpace(**SPACE), epochs=2, seed=3)
    monkeypatch.setattr(explore_mod, "initial_weights", jax_initial_weights)
    res = dse.explore(x, y, dse.DesignSpace(**SPACE), epochs=2, seed=3,
                      device="cpu")
    assert len(res.points) == len(jres.points) == 8
    for p, jp in zip(res.points, jres.points):
        assert p.index == jp.index and p.encoder == jp.encoder
        assert dataclasses.asdict(p.cfg) == dataclasses.asdict(jp.cfg)
        assert p.rand_index == jp.rand_index, p.index
        assert (p.synapses, p.area_um2, p.leakage_uw) == (
            jp.synapses, jp.area_um2, jp.leakage_uw)
        assert p.fingerprint == jp.fingerprint
        assert isinstance(p.params["w"], np.ndarray)
        assert p.params["w"].dtype == np.float32
        np.testing.assert_array_equal(p.params["w"], np.asarray(jp.params["w"]))
        assert p.lowering == "reference" and p.retries == 0
    assert [p.index for p in res.pareto] == [p.index for p in jres.pareto]
    assert res.best().index == jres.best().index
    assert res.meta["buckets"] == jres.meta["buckets"]
    assert res.meta["shards"] == 1
    assert res.meta["quarantined"] == 0 and res.meta["resumed"] == 0


def test_initial_weights_keyed_by_seed_and_index():
    cfg = ColumnConfig(p=9, q=3, t_max=16)
    w = dse.initial_weights(0, 5, cfg)
    assert w.dtype == np.float32 and w.shape == (9, 3)
    assert np.all((w >= 0) & (w <= cfg.neuron.w_max))
    np.testing.assert_array_equal(w, dse.initial_weights(0, 5, cfg))
    assert not np.array_equal(w, dse.initial_weights(0, 6, cfg))
    assert not np.array_equal(w, dse.initial_weights(1, 5, cfg))


def test_explore_results_independent_of_grouping():
    """A candidate's result depends on (seed, index) only: a sweep of a
    budget prefix, bucketed otherwise, scores its points identically."""
    x, y = _stream(30)
    full = dse.explore(x, y, dse.DesignSpace(**SPACE), epochs=1, device="cpu")
    part = dse.explore(x, y, dse.DesignSpace(**SPACE), epochs=1, budget=3,
                       max_bucket=1, device="cpu")
    assert [p.index for p in part.points] == [0, 1, 2]
    assert part.meta["buckets"] == {"latency": 3}
    for p in part.points:
        q = full.points[p.index]
        assert p.rand_index == q.rand_index
        np.testing.assert_array_equal(p.params["w"], q.params["w"])


def test_journal_resume_after_truncation_is_bit_identical(tmp_path):
    x, y = _stream(30)
    space = dse.DesignSpace(**SPACE)
    clean = dse.explore(x, y, space, epochs=1, max_bucket=3, device="cpu")
    jr = CountingJournal(tmp_path / "run.jsonl")
    first = dse.explore(x, y, space, epochs=1, max_bucket=3, journal=jr,
                        device="cpu")
    assert len(jr.sizes) > 2 and sum(jr.sizes) == 8
    lines = (tmp_path / "run.jsonl").read_text().splitlines()
    head = json.loads(lines[0])
    assert head["init"] == explore_mod.INIT and head["kind"] == "meta"
    # a kill after the first bucket was published
    (tmp_path / "run.jsonl").write_text(
        "\n".join(lines[: 1 + jr.sizes[0]]) + "\n")
    with pytest.raises(ValueError, match="resume=True"):
        dse.explore(x, y, space, epochs=1, max_bucket=3,
                    journal=tmp_path / "run.jsonl", device="cpu")
    resumed = dse.explore(x, y, space, epochs=1, max_bucket=3,
                          journal=tmp_path / "run.jsonl", resume=True,
                          device="cpu")
    assert resumed.meta["resumed"] == jr.sizes[0]
    for run in (first, resumed):
        assert [p.index for p in run.points] == [p.index for p in clean.points]
        for p, c in zip(run.points, clean.points):
            assert p.rand_index == c.rand_index
            np.testing.assert_array_equal(p.params["w"], c.params["w"])
        assert [p.index for p in run.pareto] == [p.index for p in clean.pareto]
    # resuming a finished run re-evaluates nothing
    again = dse.explore(x, y, space, epochs=1, max_bucket=3,
                        journal=tmp_path / "run.jsonl", resume=True,
                        device="cpu")
    assert again.meta["resumed"] == 8
    with pytest.raises(ValueError, match="epochs"):
        dse.explore(x, y, space, epochs=2, journal=tmp_path / "run.jsonl",
                    resume=True, device="cpu")


def test_jax_journal_refused_and_port_journal_accepted_by_jax(tmp_path):
    x, y = _stream(20)
    space = dict(SPACE, encoder=("latency",), t_max=(16,))
    jdse.explore(x, y, jdse.DesignSpace(**space), epochs=1,
                 journal=str(tmp_path / "jax.jsonl"))
    with pytest.raises(ValueError, match="init"):
        dse.explore(x, y, dse.DesignSpace(**space), epochs=1,
                    journal=tmp_path / "jax.jsonl", resume=True, device="cpu")
    dse.explore(x, y, dse.DesignSpace(**space), epochs=1,
                journal=tmp_path / "port.jsonl", device="cpu")
    restored = jdse.Journal(str(tmp_path / "port.jsonl")).begin(
        {"seed": 0, "epochs": 1, "search": "grid"}, resume=True)
    assert len(restored) == 2


def test_poisoned_candidate_quarantined_alone(monkeypatch):
    x, y = _stream(30)
    # six candidates, each with its own threshold
    space = dse.DesignSpace(q=(2,), t_max=(16,), threshold_scale=(0.75, 1.0, 1.25),
                            encoder=("latency", "onoff"))
    clean = dse.explore(x, y, space, epochs=1, device="cpu")
    poison = clean.points[1].cfg.neuron.threshold
    assert sum(p.cfg.neuron.threshold == poison for p in clean.points) == 1
    orig = fused_column.fit_scan_padded

    def poisoned(w, xs, thresholds, *args, **kwargs):
        if np.any(np.isclose(np.asarray(thresholds, np.float64), poison)):
            raise RuntimeError("injected fault: poisoned design present")
        return orig(w, xs, thresholds, *args, **kwargs)

    monkeypatch.setattr(fused_column, "fit_scan_padded", poisoned)
    res = dse.explore(x, y, space, epochs=1, device="cpu")
    assert res.meta["quarantined"] == 1
    fail = res.meta["failures"][0]
    assert fail["index"] == 1 and fail["stage"] == "fit"
    assert "injected fault" in fail["error"]
    assert [p.index for p in res.points] == [0, 2, 3, 4, 5]
    assert res.points[0].retries == 1 and res.points[2].retries == 0
    for p in res.points:
        c = clean.points[p.index]
        assert p.rand_index == c.rand_index
        np.testing.assert_array_equal(p.params["w"], c.params["w"])
    assert "quarantined" in dse.summarize(res)
    with pytest.raises(RuntimeError, match="injected fault"):
        dse.explore(x, y, space, epochs=1, on_error="raise", device="cpu")


def test_explore_guards(monkeypatch):
    x, y = _stream(10)
    space = dse.DesignSpace(q=(2,), t_max=(16,))
    with pytest.raises(ValueError, match="labels"):
        dse.explore(x, None, space, device="cpu")
    with pytest.raises(ValueError, match="unknown search"):
        dse.explore(x, y, space, search="bayes", device="cpu")
    with pytest.raises(ValueError, match="budget"):
        dse.explore(x, y, space, search="random", device="cpu")
    res = dse.explore(x, y, dse.DesignSpace(**SPACE), search="random",
                      budget=3, seed=5, epochs=1, device="cpu")
    want = [dataclasses.asdict(c) for c in
            jdse.DesignSpace(**SPACE).sample(3, seed=5)]
    got = [dict(q=p.cfg.q, t_max=p.cfg.t_max, encoder=p.encoder)
           for p in res.points]
    assert sorted(got, key=str) == sorted(
        [{k: c[k] for k in ("q", "t_max", "encoder")} for c in want], key=str)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dse.explore(x, y, space)


# ------------------------------------------------------------ straggler
def test_step_monitor_and_rebalance_policy_identical():
    rng = np.random.default_rng(0)
    steps = list(rng.uniform(0.9, 1.1, 60))
    for i in (8, 9, 11, 30, 58):
        steps[i] = 5.0
    for kw in (dict(), dict(window=10, threshold=3.0, warmup=2)):
        mon, jmon = straggler.StepMonitor(**kw), jstraggler.StepMonitor(**kw)
        for i, dt in enumerate(steps):
            label = "refit" if i % 2 else ""
            ev, jev = mon.observe(i, dt, label), jmon.observe(i, dt, label)
            assert (ev is None) == (jev is None)
            if ev is not None:
                assert dataclasses.asdict(ev) == dataclasses.asdict(jev)
            assert mon.median_s == jmon.median_s
            for patience in (1, 3):
                assert mon.should_rebalance(patience) == \
                    jmon.should_rebalance(patience)
        assert [dataclasses.asdict(e) for e in mon.events] == \
            [dataclasses.asdict(e) for e in jmon.events]
        assert mon.events
    pol, jpol = straggler.RebalancePolicy(4), jstraggler.RebalancePolicy(4)
    for slow in (1, 1, 3, 0):
        assert pol.apply(slow) == jpol.apply(slow)
    mon = straggler.StepMonitor()
    assert mon.stop() is None
    mon.start("assign")
    assert mon.stop() is None and len(mon.times) == 1


# ------------------------------------------- the volley block's split
def _smem(p, q, v_blk, t_window, resident=True):
    # csrc/fused_block.cu: tnn_fused_block_smem_bytes
    return (p * q * resident + v_blk * p + q) * 4 + (q + q * (t_window + 1)) * 4


def test_block_sub_launches_split_only_what_does_not_fit(monkeypatch):
    monkeypatch.setattr(build.FUSED_BLOCK, "smem_bytes", _smem)
    # the sweeps' 270 x 50 envelope fits a block of 32: one launch
    assert fused_column.block_sub_launches(270, 50, 32, 32, 64) == [(0, 32, 32)]
    assert fused_column.block_sub_launches(270, 50, 32, 4, 64) == [(0, 32, 4)]
    # so does the on/off 540 x 50 envelope (51 volleys fit beside its
    # weights and the fire's histogram)
    assert (build.MAX_SMEM_BYTES - _smem(540, 50, 0, 64)) // (540 * 4) == 51
    assert fused_column.block_sub_launches(540, 50, 32, 30, 64) == [(0, 32, 30)]
    # a 1000 x 40 envelope fits 15 volleys beside its weights
    v_fit = (build.MAX_SMEM_BYTES - _smem(1000, 40, 0, 64)) // (1000 * 4)
    assert v_fit == 15
    plan = fused_column.block_sub_launches(1000, 40, 32, 30, 64)
    assert plan == [(0, 15, 15), (15, 15, 15)]
    assert fused_column.block_sub_launches(1000, 40, 32, 32, 64)[-1] == (30, 2, 2)
    assert fused_column.block_sub_launches(1000, 40, 32, 4, 64) == [(0, 4, 4)]
    # the window sizes the histogram: at t_window 32, 16 volleys fit
    assert fused_column.block_sub_launches(1000, 40, 32, 30, 32)[0] == (0, 16, 16)
    # a single volley of ~57 K synapses no longer fits
    assert _smem(1200, 48, 1, 64) > build.MAX_SMEM_BYTES


def test_sub_block_fold_equals_the_whole_block(monkeypatch):
    """Folding the plan's sub-blocks in order is the whole block's fold
    (plain versions, at a width where the plan splits)."""
    # a card on which only 4 volleys fit beside the weights
    monkeypatch.setattr(build.FUSED_BLOCK, "smem_bytes",
                        lambda p, q, v, t, resident=True: build.MAX_SMEM_BYTES + (v > 4))
    rng = np.random.default_rng(0)
    d, p, q, v_blk, n_valid = 3, 24, 6, 12, 10
    plan = fused_column.block_sub_launches(p, q, v_blk, n_valid, 32)
    assert len(plan) > 1 and sum(v for _, v, _ in plan) == n_valid
    w = torch.from_numpy(rng.uniform(0, 7, (d, p, q)).astype(np.float32))
    t_in = torch.from_numpy(rng.integers(0, 36, (d, v_blk, p)).astype(np.float32))
    ops = fused_column.design_operands([20.0, 30.0, 25.0], [32, 24, 32],
                                       [6, 4, 5], 0.5, 0.5, 1 / 1024)
    kw = dict(t_window=32, w_max=7, wta_k=1, stabilize=True)
    whole = fused_column.fused_block_padded_plain(w, t_in, ops, n_valid, **kw)
    split = w
    for start, v, nv in plan:
        split = fused_column.fused_block_padded_plain(
            split, t_in[:, start : start + v].contiguous(), ops, nv, **kw)
    assert torch.equal(whole, split)
    assert not torch.equal(whole, w)
