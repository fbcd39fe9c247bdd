"""The port's cost model: plan contract, constants fallback, invariance.

Mirrors the JAX package's ``tests/test_costmodel.py`` where it has a
meaning on the card:

* every plan the chooser can emit keeps the contract (property test);
* with no active profile every seam is today's constants plan, equal to
  the JAX package's constants;
* a plan changes the blocking and the bucketing, never a result: under a
  'host-cpu' and a card profile the sweep trains bit-identical weights
  and ids to the constants plan's;
* calibration records round-trip through disk and never activate on a
  mismatched host, card count or version.

The ``'cuda'`` footprint check takes ``csrc/fused_block.cu``'s shared
memory formula (the layout tests' mirror), since no kernel builds here.
Tests never leave a profile active.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import backend as jbackend
from repro.roofline import costmodel as jcostmodel
from repro_torch.core import backend, simulator
from repro_torch.core.types import ColumnConfig, STDPConfig
from repro_torch.kernels import build
from repro_torch.roofline import costmodel

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _hermetic_costmodel():
    prev = costmodel.profile()
    costmodel._choose_plan_cached.cache_clear()
    yield
    costmodel.set_profile(prev)
    costmodel._choose_plan_cached.cache_clear()


def _fused_block_smem(p, q, v_blk, t_window, resident=True):
    # csrc/fused_block.cu: tnn_fused_block_smem_bytes (as in the layout
    # tests of tests/test_torch_flash.py)
    return (p * q * resident + v_blk * p + q) * 4 + (q + q * (t_window + 1)) * 4


def _fits(p, q, v_blk, t_window) -> bool:
    """``block_sub_launches``' one-launch rule on the mirror formula."""
    cap = build.MAX_SMEM_BYTES
    resident = _fused_block_smem(p, q, 1, t_window) <= cap
    return _fused_block_smem(p, q, v_blk, t_window, resident) <= cap


def _synth_profile(**kw) -> costmodel.DeviceProfile:
    kw = dict(dict(name="synth", calibrated=True), **kw)
    return dataclasses.replace(costmodel.PROFILES["host-cpu"], **kw)


# ------------------------------------------------------ plan contract
@settings(max_examples=60, deadline=None)
@given(
    d=st.integers(1, 16),
    p=st.integers(1, 2000),
    q=st.integers(1, 64),
    t=st.integers(1, 128),
    n=st.integers(1, 1024),
    epochs=st.integers(1, 8),
    kind=st.sampled_from(["fit", "assign"]),
    lowering=st.sampled_from(["reference", "cuda"]),
    peak=st.floats(1e9, 1e15),
    bw=st.floats(1e8, 1e13),
    dispatch=st.floats(1e-7, 1e-3),
    bucket_s=st.floats(1e-4, 10.0),
    eff=st.floats(1e-4, 50.0),
)
def test_any_plan_is_valid(d, p, q, t, n, epochs, kind, lowering, peak, bw,
                           dispatch, bucket_s, eff):
    prof = _synth_profile(peak_flops=peak, hbm_bw=bw, dispatch_s=dispatch,
                          bucket_s=bucket_s, fused_eff=eff)
    plan = costmodel.choose_plan(kind, lowering, d, p, q, t, n, epochs,
                                 prof=prof, fits=_fits)
    assert costmodel.plan_is_valid(plan), plan
    assert plan.source == "costmodel" and plan.profile == "synth"
    cap = (costmodel.CONST_V_BLK_REFERENCE if lowering == "reference"
           else costmodel.CONST_V_BLK_KERNEL)
    assert plan.v_blk <= cap and plan.shards == 1
    assert 1.5 <= plan.waste_cap <= 8.0
    assert plan.predicted_step_s > 0
    if lowering == "cuda" and any(_fits(p, q, v, t) for v in (1, 2)):
        # the kernel folds the chosen block in one launch
        assert plan.v_blk == 1 or _fits(p, q, plan.v_blk, t), plan
    cplan = costmodel.constants_plan(kind, lowering, d, n)
    assert costmodel.plan_is_valid(cplan) and cplan.source == "constants"


def test_plan_is_hashable_and_deterministic():
    prof = _synth_profile()
    a = costmodel.choose_plan("fit", "reference", 4, 96, 10, 64, 64, 4, prof=prof)
    b = costmodel.choose_plan("fit", "reference", 4, 96, 10, 64, 64, 4, prof=prof)
    assert a == b and hash(a) == hash(b)
    assert {a: "plan"}[b] == "plan"


def test_cuda_candidates_are_the_blocks_the_kernel_folds_in_one_launch():
    prof = costmodel.PROFILES["h100-sxm"]
    # the sweeps' 270 x 50 envelope folds 32 volleys in one launch
    plan = costmodel.choose_plan("fit", "cuda", 12, 270, 50, 64, 905, 8,
                                 prof=prof, fits=_fits)
    assert plan.v_blk == 32
    # at 1000 x 40 a launch folds 15 volleys: the largest power of two
    # that fits is 8
    assert _fits(1000, 40, 15, 64) and not _fits(1000, 40, 16, 64)
    plan = costmodel.choose_plan("fit", "cuda", 4, 1000, 40, 64, 905, 8,
                                 prof=prof, fits=_fits)
    assert plan.v_blk == 8
    # the stream clamps the candidates
    plan = costmodel.choose_plan("fit", "cuda", 1, 270, 25, 64, 5, 1,
                                 prof=prof, fits=_fits)
    assert plan.v_blk == 4


def test_kernel_fits_is_block_sub_launches_one_launch_rule(monkeypatch):
    monkeypatch.setattr(build.FUSED_BLOCK, "smem_bytes", _fused_block_smem)
    for p, q, t in ((270, 50, 64), (540, 50, 64), (637, 50, 64),
                    (650, 130, 64), (1000, 40, 64), (4000, 8, 64)):
        for v in (1, 2, 4, 8, 16, 32):
            assert costmodel.kernel_fits(p, q, v, t) == _fits(p, q, v, t), (p, q, v)
    # the chooser's default footprint check is the kernel's own rule
    prof = costmodel.PROFILES["h100-sxm"]
    assert costmodel.choose_plan("fit", "cuda", 4, 1000, 40, 64, 905, 8,
                                 prof=prof).v_blk == 8


def test_analytic_cost_counts_the_slope_form_and_the_dense_ramp():
    d, p, q, t = 12, 270, 50, 64
    flops, byts = costmodel.analytic_volley_cost(d, p, q, t, "cuda", 32)
    assert flops == d * (12 * p * q + 2 * q * t)
    assert byts == 4 * (2 * d * p * q + d * 32 * p + 6 * d) / 32
    # the weights stay on chip across a block: bytes per volley fall
    per_volley = [costmodel.analytic_volley_cost(d, p, q, t, "cuda", v)[1]
                  for v in (1, 2, 8, 32)]
    assert per_volley == sorted(per_volley, reverse=True)
    ref_flops, _ = costmodel.analytic_volley_cost(d, p, q, t, "reference")
    assert ref_flops == d * (2 * p * q * t + 10 * p * q)


# ------------------------------------------------- constants fallback
def test_uncalibrated_plans_equal_the_constants_plan():
    """With no active profile every execution_plan is today's constants
    plan, equal to the JAX package's constants (the grid of
    tests/test_torch_sweep.py)."""
    costmodel.set_profile(None)
    for low, jlow in (("cuda", "mosaic"), ("reference", "reference")):
        for n in (1, 5, 7, 31, 900):
            for d in (1, 2, 3, 12):
                for kind in ("fit", "assign"):
                    plan = backend.execution_plan(kind, low, d, 270, 50, 64, n, 4)
                    assert plan == costmodel.constants_plan(kind, low, d, n)
                    jplan = jcostmodel.constants_plan(kind, jlow, d, n)
                    assert plan.v_blk == jplan.v_blk
                    assert plan.waste_cap == jplan.waste_cap == backend.ENVELOPE_WASTE_CAP
                    assert plan.source == "constants" and plan.profile == ""
                    assert plan.shards == backend.design_shards(d) == 1
                assert backend.execution_plan("fit", low, d, 270, 50, 64, n).v_blk \
                    == backend.volley_block(low, n, d)
    assert costmodel.choose_waste_cap() == backend.ENVELOPE_WASTE_CAP
    assert costmodel.choose_shards(4) == 1


SHAPES = [
    [(20, 5, 24), (20, 2, 12), (20, 3, 20)],
    [(270, 25, 64), (270, 50, 64), (270, 25, 32), (270, 50, 32)] * 3,
    [(65, 2, 64), (637, 2, 64), (470, 5, 64), (270, 25, 64), (96, 2, 32)],
    [(8, 2, 16), (8, 96, 16), (8, 4, 16), (8, 2, 16)],
]


@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: f"{len(s)}shapes")
def test_envelope_buckets_without_a_profile_ignore_the_stream(shapes):
    costmodel.set_profile(None)
    base = backend.envelope_buckets(shapes)
    assert backend.envelope_buckets(shapes, n_volleys=905, epochs=8) == base
    assert base == jbackend.envelope_buckets(shapes, n_volleys=905, epochs=8)


def test_waste_cap_with_profile_is_clamped_and_breaks_even():
    prof = _synth_profile()
    short = costmodel.choose_waste_cap(prof, 4, 96, 10, 64, n_volleys=1)
    long = costmodel.choose_waste_cap(prof, 4, 96, 10, 64, n_volleys=200_000,
                                      epochs=8)
    assert 1.5 <= long <= short <= 8.0
    assert short == 8.0 and long == 1.5
    # inside the clamp the cap is the break-even: padding waste over the
    # stream equals one bucket's fixed cost
    flops, byts = costmodel.analytic_volley_cost(4, 96, 10, 64, "reference", 8)
    volley_s = max(flops / prof.peak_flops, byts / prof.hbm_bw)
    total = int(prof.bucket_s / volley_s / 2.0)  # cap ~ 3
    cap = costmodel.choose_waste_cap(prof, 4, 96, 10, 64, n_volleys=total)
    assert 1.5 < cap < 8.0
    assert cap == pytest.approx(1.0 + prof.bucket_s / (volley_s * total))
    assert (cap - 1.0) * volley_s * total == pytest.approx(prof.bucket_s)


# ------------------------------------------------------- persistence
def _host_profile(**kw) -> costmodel.DeviceProfile:
    platform, kind, count = costmodel.host_identity()
    base = dict(platform=platform, device_kind=kind, n_devices=count)
    base.update(kw)
    return _synth_profile(**base)


def test_calibration_round_trip(tmp_path):
    path = str(tmp_path / "calibration.json")
    prof = _host_profile()
    assert costmodel.save_profile(prof, path) == path
    costmodel.set_profile(None)
    assert costmodel.load_profile(path) == prof
    assert costmodel.profile() == prof  # load ACTIVATES
    assert json.loads(pathlib.Path(path).read_text())["version"] == \
        costmodel.CALIBRATION_VERSION


@pytest.mark.parametrize("field,value", [
    ("device_kind", "NVIDIA H100 80GB HBM3 (another card)"),
    ("n_devices", 4),
    ("platform", "cuda-elsewhere"),
    ("version", costmodel.CALIBRATION_VERSION + 1),
])
def test_calibration_rejects_a_mismatched_record(tmp_path, field, value):
    path = tmp_path / "calibration.json"
    d = _host_profile().to_json()
    d[field] = value
    path.write_text(json.dumps(d))
    costmodel.set_profile(None)
    assert costmodel.load_profile(str(path)) is None
    assert costmodel.profile() is None
    assert costmodel.load_profile(str(tmp_path / "missing.json")) is None


def test_calibration_lives_beside_the_built_kernels():
    assert pathlib.Path(costmodel.calibration_path()) == \
        build.BUILD_DIR / costmodel.CALIBRATION_FILE
    assert costmodel.PROFILES["h100-sxm"].footprint_bytes == build.MAX_SMEM_BYTES
    assert costmodel.PROFILES["h100-sxm"].link_bw == 0.0
    assert "tpu-v5e" not in costmodel.PROFILES
    assert not any(p.calibrated for p in costmodel.PROFILES.values())


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
    """The module imports on its own, before the rest of the package
    (``python -m repro_torch.roofline.costmodel`` does so)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c",
                    "from repro_torch.roofline import costmodel\n"
                    "assert costmodel.profile() is None\n"],
                   check=True, env=env, timeout=120)
    out = subprocess.run([sys.executable, "-m", "repro_torch.roofline.costmodel",
                          "--help"], check=True, env=env, timeout=120,
                         capture_output=True, text=True)
    assert "--force" in out.stdout and "Warning" not in out.stderr, out.stderr


def test_calibrate_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        costmodel.calibrate(persist=False)
    assert costmodel.profile() is None


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


@pytest.mark.parametrize("profile_name", ["host-cpu", "h100-sxm"])
@pytest.mark.parametrize("n_designs", [1, 2, 3])
def test_plan_blocking_is_bit_identical_to_constants(profile_name, n_designs):
    """The sweep under a profile (another v_blk, and another waste cap)
    trains bit-identical weights and ids to the constants plan's."""
    x, y, cfgs, w_init = _sweep_case(n_designs)

    def run():
        return simulator.cluster_time_series_many(
            x, y, cfgs, epochs=2, w_init=w_init, device="cpu")

    with costmodel.override(None):
        const = run()
    prof = costmodel.PROFILES[profile_name]
    with costmodel.override(prof):
        planned = run()
    for a, b in zip(const, planned):
        assert a.plan["source"] == "constants"
        assert b.plan["source"] == "costmodel" and b.plan["profile"] == profile_name
        assert np.array_equal(a.assignments, b.assignments)
        assert a.rand_index == b.rand_index
        assert np.array_equal(a.params["w"].numpy(), b.params["w"].numpy())
    # the schedules differ: equality would make this test vacuous
    assert any(a.plan["v_blk"] != b.plan["v_blk"] for a, b in zip(const, planned))
    with costmodel.override(prof):
        plan = backend.execution_plan("fit", "reference", 1, 24, 2, 16, 27, 2)
    assert plan.v_blk == 8 != costmodel.constants_plan("fit", "reference", 1, 27).v_blk


def test_network_under_a_profile_is_bit_identical():
    from repro_torch.core import network
    from repro_torch.core.types import LayerConfig, NetworkConfig

    grid = STDPConfig(mu_capture=1.0, mu_backoff=1.0, mu_search=1.0,
                      stabilizer="none")
    c1 = ColumnConfig(p=24, q=3, t_max=16, stdp=grid)
    c1 = c1.with_threshold(simulator.suggest_threshold(c1))
    c2 = ColumnConfig(p=6, q=2, t_max=16, stdp=grid).with_threshold(3.0)
    net = NetworkConfig(layers=(LayerConfig(columns=2, column=c1),
                                LayerConfig(columns=1, column=c2)))
    import torch

    w0 = network.init_params(net, 24, torch.Generator().manual_seed(0), "cpu")
    x = np.random.default_rng(5).normal(size=(20, 24))
    with costmodel.override(None):
        a = simulator.cluster_time_series_network(x, None, net, epochs=2,
                                                  device="cpu", params=w0)
    with costmodel.override(costmodel.PROFILES["host-cpu"]):
        b = simulator.cluster_time_series_network(x, None, net, epochs=2,
                                                  device="cpu", params=w0)
    assert np.array_equal(a.assignments, b.assignments)
    for la, lb in zip(a.params["layers"], b.params["layers"]):
        assert torch.equal(la["w"], lb["w"])


# -------------------------------------------------- consumer threading
def test_sweep_records_plan_metadata():
    x, y, cfgs, w_init = _sweep_case(2)
    with costmodel.override(costmodel.PROFILES["host-cpu"]):
        res = simulator.cluster_time_series_many(x, y, cfgs, epochs=1,
                                                 w_init=w_init, device="cpu")
    for r in res:
        assert r.plan["kind"] == "fit" and r.plan["source"] == "costmodel"
        assert r.plan["profile"] == "host-cpu" and r.plan["v_blk"] >= 1
        assert r.plan["predicted_step_us"] > 0


def test_service_surfaces_plans():
    from repro_torch.serve import ClusteringService

    c = ColumnConfig(p=8, q=2, t_max=16)
    c = c.with_threshold(simulator.suggest_threshold(c))
    with costmodel.override(costmodel.PROFILES["host-cpu"]):
        svc = ClusteringService({"d0": c}, batch_size=2, refit_every=4,
                                refit_window=4, device="cpu")
    stats = svc.stats()
    assert len(stats.plans) == len(svc.buckets())
    asg_meta, fit_meta = stats.plans[0]
    assert asg_meta["kind"] == "assign" and fit_meta["kind"] == "fit"
    assert fit_meta["source"] == "costmodel" and fit_meta["profile"] == "host-cpu"
    assert fit_meta["v_blk"] == 4  # the largest candidate the window allows
    for b in svc.buckets():
        assert b["assign_plan"]["source"] == "costmodel"


def test_explore_records_and_loads_the_persisted_profile(tmp_path, monkeypatch):
    from repro_torch import dse

    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(12, 16)), rng.integers(0, 2, 12)
    space = dse.DesignSpace(q=(2,), t_max=(16,), threshold_scale=(1.0,),
                            encoder=("latency",))
    costmodel.set_profile(None)
    res = dse.explore(x, y, space, epochs=1, device="cpu")
    assert res.meta["profile"] == ""
    # a journaled run loads the record persisted beside the built kernels
    path = tmp_path / "calibration.json"
    monkeypatch.setattr(costmodel, "calibration_path", lambda: str(path))
    prof = _host_profile(name="persisted")
    costmodel.save_profile(prof)
    res_j = dse.explore(x, y, space, epochs=1, device="cpu",
                        journal=str(tmp_path / "dse.jsonl"))
    assert costmodel.profile() == prof
    assert res_j.meta["profile"] == "persisted"
    assert res_j.points[0].plan["source"] == "costmodel"
    np.testing.assert_array_equal(res_j.points[0].params["w"], res.points[0].params["w"])
