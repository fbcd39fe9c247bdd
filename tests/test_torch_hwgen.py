"""Port parity, part 7: the hardware generator and the Table II specs.

The port keeps its own copy of the JAX package's ``hwgen`` (numpy,
hashlib and json only).  For the seven Table II designs
(``configs.tnn_columns.hardware_spec``) both packages must emit the same
RTL and TCL text (but for the banner, which names the generator that
wrote the file), the same ``FlowResult`` (every field but ``build_dir``,
the flow's hash-seeded jitter included) and the same forecasts.  No
tolerance: the copies do the same float arithmetic in the same order.
"""
import dataclasses
import os

import numpy as np
import pytest

from repro.configs import tnn_columns as jcolumns
from repro.hwgen import flow as jflow
from repro.hwgen import forecast as jforecast
from repro.hwgen import pdk as jpdk
from repro.hwgen import rtl as jrtl
from repro.hwgen import tcl as jtcl
from repro_torch.configs import tnn_columns
from repro_torch.hwgen import flow, forecast, pdk, rtl, tcl

BENCHMARKS = tnn_columns.all_benchmarks()


def _as_jax_banner(files: dict) -> dict:
    """Generated files with the port's generator name in the banner
    replaced by the JAX package's; nothing else is touched."""
    return {k: v.replace("by repro_torch.hwgen", "by repro.hwgen")
            for k, v in files.items()}


def _specs(name):
    spec = tnn_columns.hardware_spec(name)
    jspec = jcolumns.hardware_spec(name)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    return spec, jspec


@pytest.mark.parametrize("name", BENCHMARKS)
def test_rtl_and_tcl_text_identical(name):
    spec, jspec = _specs(name)
    files = rtl.generate_column(spec)
    assert all("by repro_torch.hwgen" in v for k, v in files.items()
               if not k.startswith("tb_"))
    assert _as_jax_banner(files) == jrtl.generate_column(jspec)
    assert rtl.netlist_stats(spec) == jrtl.netlist_stats(jspec)
    for lib in pdk.LIBRARIES:
        assert _as_jax_banner(tcl.generate_flow_scripts(spec, lib)) == \
            jtcl.generate_flow_scripts(jspec, lib)


@pytest.mark.parametrize("name", BENCHMARKS)
def test_flow_result_identical(name, tmp_path):
    spec, jspec = _specs(name)
    for lib in pdk.LIBRARIES:
        for seed in (0, 3):
            got = flow.run_flow(spec, lib, str(tmp_path / "port"),
                                executor=flow.ModelExecutor(seed=seed))
            want = jflow.run_flow(jspec, lib, str(tmp_path / "jax"),
                                  executor=jflow.ModelExecutor(seed=seed))
            a, b = got.to_json(), want.to_json()
            assert a.pop("build_dir") != b.pop("build_dir")
            assert a == b, (lib, seed)
            for fname in sorted(os.listdir(got.build_dir)):
                if fname == "reports":
                    continue
                with open(os.path.join(got.build_dir, fname)) as f, open(
                    os.path.join(want.build_dir, fname)
                ) as g:
                    body, jbody = f.read(), g.read()
                if fname == "flow_result.json":
                    body = body.replace(str(tmp_path / "port"), "")
                    jbody = jbody.replace(str(tmp_path / "jax"), "")
                assert _as_jax_banner({fname: body})[fname] == jbody, fname
    assert flow.run_flow(spec).to_json() == dict(
        jflow.run_flow(jspec).to_json())  # no build root: build_dir None


def test_cadence_executor_refuses():
    spec, _ = _specs("Beef")
    with pytest.raises(RuntimeError, match="Cadence"):
        flow.run_flow(spec, "tnn7", executor=flow.CadenceExecutor())
    with pytest.raises(ValueError, match="unknown library"):
        flow.run_flow(spec, "sky130")


def test_pdk_models_and_latency_identical():
    for lib in pdk.LIBRARIES:
        assert dataclasses.asdict(pdk.MODELS[lib]) == dataclasses.asdict(
            jpdk.MODELS[lib])
        for syn in (1, 100, 130, 1000, 6750, 20000):
            m, jm = pdk.MODELS[lib], jpdk.MODELS[lib]
            assert m.area_um2(syn) == jm.area_um2(syn)
            assert m.leakage_uw(syn) == jm.leakage_uw(syn)
            assert m.synth_runtime_s(syn) == jm.synth_runtime_s(syn)
            assert m.pnr_runtime_s(syn) == jm.pnr_runtime_s(syn)
    for p, q in ((65, 2), (270, 25), (540, 50), (1, 1)):
        assert pdk.latency_model_ns(p, q) == jpdk.latency_model_ns(p, q)


def test_forecasters_identical(tmp_path):
    paper, jpaper = forecast.PaperForecaster(), jforecast.PaperForecaster()
    for syn in (130, 6750, 13500, 27000):
        assert paper.area_um2(syn) == jpaper.area_um2(syn)
        assert paper.leakage_uw(syn) == jpaper.leakage_uw(syn)
    fc, jfc = forecast.Forecaster(), jforecast.Forecaster()
    with pytest.raises(ValueError):
        fc.fit("tnn7")
    with pytest.raises(RuntimeError):
        fc.area_um2(10)
    for name in BENCHMARKS:
        spec, jspec = _specs(name)
        fc.add_runs([flow.run_flow(spec, lib) for lib in pdk.LIBRARIES])
        jfc.add_runs([jflow.run_flow(jspec, lib) for lib in jpdk.LIBRARIES])
    for lib in pdk.LIBRARIES:
        fc.fit(lib)
        jfc.fit(lib)
        for syn in (130, 6750, 13500):
            assert fc.area_um2(syn) == jfc.area_um2(syn)
            assert fc.leakage_uw(syn) == jfc.leakage_uw(syn)
    assert forecast.Forecaster.error_pct(105.0, 100.0) == \
        jforecast.Forecaster.error_pct(105.0, 100.0)
    rng = np.random.default_rng(0)
    feats = rng.uniform(0, 10, (12, 4))
    targets = {t: rng.uniform(0, 1, 12) for t in forecast.RooflineForecaster.TERMS}
    rf, jrf = forecast.RooflineForecaster(), jforecast.RooflineForecaster()
    rf.fit(feats, targets)
    jrf.fit(feats, targets)
    got, want = rf.predict(feats[:3]), jrf.predict(feats[:3])
    for t in forecast.RooflineForecaster.TERMS:
        np.testing.assert_array_equal(got[t], want[t])
    rf.save(str(tmp_path / "rf.json"))
    back = jforecast.RooflineForecaster.load(str(tmp_path / "rf.json"))
    for t in forecast.RooflineForecaster.TERMS:
        np.testing.assert_array_equal(back.predict(feats[:3])[t], want[t])


def test_design_sweep_identical():
    specs = [tnn_columns.hardware_spec(n) for n in BENCHMARKS[:3]]
    jspecs = [jcolumns.hardware_spec(n) for n in BENCHMARKS[:3]]
    got = [r.to_json() for r in flow.run_design_sweep(specs)]
    want = [r.to_json() for r in jflow.run_design_sweep(jspecs)]
    assert got == want and len(got) == 3 * len(pdk.LIBRARIES)
