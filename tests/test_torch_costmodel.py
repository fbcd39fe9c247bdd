"""The port's padded-scan schedule: the constants plan, and invariance.

* every ``backend.execution_plan`` is the constants plan, equal to the
  JAX package's (the same ``v_blk`` and waste cap), whatever the stream;
* a block size changes the blocking, never a result: the sweep and a
  two-layer network train bit-identical weights and ids under block sizes
  other than the constants';
* the plan reaches the sweep's results and the service's stats.

No test leaves a profile active.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import backend as jbackend
from repro.roofline import costmodel as jcostmodel
from repro_torch.core import backend, simulator
from repro_torch.core.types import ColumnConfig, STDPConfig
from repro_torch.roofline import costmodel

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

JAX_LOWERING = {"cuda": "mosaic", "reference": "reference"}


def _fixed_block(monkeypatch, v_blk: int) -> None:
    """Every plan folds ``v_blk`` volleys a block (never more than the
    stream), in place of the constants."""
    monkeypatch.setattr(costmodel, "const_v_blk",
                        lambda lowering, n_volleys, d=None: max(1, min(v_blk, int(n_volleys))))


# ------------------------------------------------------------- the plan
def test_plan_is_hashable_and_deterministic():
    a = backend.execution_plan("fit", "reference", 4, 64)
    b = backend.execution_plan("fit", "reference", 4, 64)
    assert a == b and hash(a) == hash(b)
    assert {a: "plan"}[b] == "plan"
    assert costmodel.plan_is_valid(a)


def test_uncalibrated_plans_equal_the_constants_plan():
    """Every execution_plan is the constants plan, equal to the JAX
    package's constants (the grid of tests/test_torch_sweep.py)."""
    for low, jlow in JAX_LOWERING.items():
        for n in (1, 5, 7, 31, 900):
            for d in (1, 2, 3, 12):
                for kind in ("fit", "assign"):
                    plan = backend.execution_plan(kind, low, d, n)
                    assert plan == costmodel.constants_plan(kind, low, d, n)
                    assert costmodel.plan_is_valid(plan)
                    jplan = jcostmodel.constants_plan(kind, jlow, d, n)
                    assert plan.v_blk == jplan.v_blk
                    assert plan.waste_cap == jplan.waste_cap == backend.ENVELOPE_WASTE_CAP
                    assert plan.shards == 1
                    meta = plan.meta()
                    assert (meta["source"], meta["profile"]) == ("constants", "")
                assert backend.execution_plan("fit", low, d, n).v_blk \
                    == backend.volley_block(low, n, d)


@settings(max_examples=60, deadline=None)
@given(
    kind=st.sampled_from(["fit", "assign"]),
    lowering=st.sampled_from(sorted(JAX_LOWERING)),
    d=st.integers(1, 16),
    n=st.integers(1, 1024),
    epochs=st.integers(1, 8),
    p=st.integers(1, 2000),
    q=st.integers(1, 64),
    t=st.integers(1, 128),
)
def test_execution_plan_is_the_jax_constants_plan(kind, lowering, d, n, epochs, p, q, t):
    """The port's plan is the JAX package's plan with no profile active,
    at any stream length, epoch count and envelope."""
    plan = backend.execution_plan(kind, lowering, d, n)
    jlow = JAX_LOWERING[lowering]
    jconst = jcostmodel.constants_plan(kind, jlow, d, n)
    with jcostmodel.override(None):
        jplan = jbackend.execution_plan(kind, jlow, d, p, q, t, n, epochs)
    assert (plan.v_blk, plan.waste_cap) == (jconst.v_blk, jconst.waste_cap) \
        == (jplan.v_blk, jplan.waste_cap)


def test_importing_the_library_activates_no_profile():
    code = (
        "import repro_torch, repro_torch.core.backend, repro_torch.core.simulator, "
        "repro_torch.dse, repro_torch.serve, repro_torch.clustering\n"
        "from repro_torch.roofline import costmodel\n"
        "assert costmodel.profile() is None\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_costmodel_imports_first_and_its_cli_starts():
    """The module imports on its own, before the rest of the package."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c",
                    "from repro_torch.roofline import costmodel\n"
                    "assert costmodel.profile() is None\n"],
                   check=True, env=env, timeout=120)


# ------------------------------------------------------- invariance
def _sweep_case(n_designs):
    rng = np.random.default_rng(n_designs)
    x = rng.normal(size=(27, 24))
    y = rng.integers(0, 3, 27)
    grid = STDPConfig(mu_capture=1.0, mu_backoff=1.0, mu_search=1.0,
                      stabilizer="none")
    cfgs = []
    for i in range(n_designs):
        c = ColumnConfig(p=24, q=2 + i, t_max=(16, 32, 16)[i], stdp=grid)
        cfgs.append(c.with_threshold(simulator.suggest_threshold(c)))
    w_init = [rng.integers(0, 8, (c.p, c.q)).astype(np.float32) for c in cfgs]
    return x, y, cfgs, w_init


# The constants block the reference lowering's sweep at 2, 4, 6 or 8
# volleys: 3 and 5 are blocks no constants plan of these sweeps uses.
@pytest.mark.parametrize("v_blk", [3, 5])
@pytest.mark.parametrize("n_designs", [1, 2, 3])
def test_sweep_is_the_same_under_any_block_size(monkeypatch, n_designs, v_blk):
    """The sweep under another block size trains bit-identical weights
    and ids to the constants plan's."""
    x, y, cfgs, w_init = _sweep_case(n_designs)

    def run():
        return simulator.cluster_time_series_many(
            x, y, cfgs, epochs=2, w_init=w_init, device="cpu")

    const = run()
    with monkeypatch.context() as m:
        _fixed_block(m, v_blk)
        blocked = run()
    for a, b in zip(const, blocked):
        assert b.plan["v_blk"] == v_blk != a.plan["v_blk"]
        assert np.array_equal(a.assignments, b.assignments)
        assert a.rand_index == b.rand_index
        assert np.array_equal(a.params["w"].numpy(), b.params["w"].numpy())


def test_network_is_the_same_under_any_block_size(monkeypatch):
    from repro_torch.core import network
    from repro_torch.core.types import LayerConfig, NetworkConfig

    grid = STDPConfig(mu_capture=1.0, mu_backoff=1.0, mu_search=1.0,
                      stabilizer="none")
    c1 = ColumnConfig(p=24, q=3, t_max=16, stdp=grid)
    c1 = c1.with_threshold(simulator.suggest_threshold(c1))
    c2 = ColumnConfig(p=6, q=2, t_max=16, stdp=grid).with_threshold(3.0)
    net = NetworkConfig(layers=(LayerConfig(columns=2, column=c1),
                                LayerConfig(columns=1, column=c2)))
    w0 = network.init_params(net, 24, torch.Generator().manual_seed(0), "cpu")
    x = np.random.default_rng(5).normal(size=(20, 24))

    def run():
        return simulator.cluster_time_series_network(x, None, net, epochs=2,
                                                     device="cpu", params=w0)

    a = run()
    with monkeypatch.context() as m:
        _fixed_block(m, 3)
        b = run()
    assert [lp["v_blk"] for lp in a.plan["layers"]] == [4, 2]
    assert [lp["v_blk"] for lp in b.plan["layers"]] == [3, 3]
    assert np.array_equal(a.assignments, b.assignments)
    for la, lb in zip(a.params["layers"], b.params["layers"]):
        assert torch.equal(la["w"], lb["w"])


# -------------------------------------------------- consumer threading
def test_sweep_records_plan_metadata():
    x, y, cfgs, w_init = _sweep_case(2)
    res = simulator.cluster_time_series_many(x, y, cfgs, epochs=1,
                                             w_init=w_init, device="cpu")
    for r in res:
        assert r.plan["kind"] == "fit" and r.plan["source"] == "constants"
        assert r.plan["profile"] == "" and r.plan["predicted_step_us"] == 0.0
        assert r.plan["v_blk"] == backend.volley_block("reference", 27, len(cfgs))


def test_service_surfaces_plans():
    from repro_torch.serve import ClusteringService

    c = ColumnConfig(p=8, q=2, t_max=16)
    c = c.with_threshold(simulator.suggest_threshold(c))
    svc = ClusteringService({"d0": c}, batch_size=2, refit_every=4,
                            refit_window=4, device="cpu")
    stats = svc.stats()
    assert len(stats.plans) == len(svc.buckets())
    asg_meta, fit_meta = stats.plans[0]
    assert asg_meta["kind"] == "assign" and fit_meta["kind"] == "fit"
    assert fit_meta["source"] == "constants" and fit_meta["profile"] == ""
    assert fit_meta["v_blk"] == backend.volley_block("reference", 4, 1) == 2
    for b in svc.buckets():
        assert b["assign_plan"] == backend.execution_plan(
            "assign", "reference", 1, 2).meta()
