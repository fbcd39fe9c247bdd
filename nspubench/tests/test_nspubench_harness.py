"""The harness on the CPU: cells found from files, tiny cells run end to
end, the import guard, planted faults and the control."""
from __future__ import annotations

import ast
import io
import json
import pathlib
import sys

import numpy as np
import pytest

from nspubench import guard, run
from nspubench.tests.conftest import TINY_CELLS

PACKAGE = pathlib.Path(__file__).resolve().parents[1]


def _run(root, cell, trace=False, seed=2**33 + 5, seconds=0.3):
    buf = io.StringIO()
    line = run.run(cell, seed, seconds, trace, root=root, device="cpu",
                   t_start=0.0, out=buf,
                   loaded_before=guard.forbidden_modules())
    return line, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cell_found_from_files_alone(tiny_root):
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cell = run.find_cell(manifest, "tiny-grid.serve", tiny_root)
    assert cell["traffic"]["generator"] == "serve"
    assert cell["config"]["designs"][1]["dataset"] == "Beef"
    assert [m["name"] for m in cell["end_to_end"]] == [
        "serve_p50_ms", "serve_p95_ms", "served_per_s", "setup_s"]
    assert "fire_block_roofline" in [m["name"] for m in cell["per_layer"]]
    with pytest.raises(SystemExit):
        run.find_cell(manifest, "no-such.cell", tiny_root)


def test_real_manifest_names_files_that_exist():
    root = PACKAGE.parent
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for w in manifest["workloads"]:
        cell = run.find_cell(manifest, w["name"], root)
        run.load_generator(cell["traffic"]["generator"])
        for m in cell["per_layer"]:
            assert callable(run.load_reader(m["name"]).read)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_end_to_end(tiny_root, cell, trace):
    _, line = _run(tiny_root, cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    if not trace:
        assert set(line["metrics"]) == set(TINY_CELLS[cell][2]) | {"setup_s"}
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        # no device trace on the CPU: only the spans' metrics are read
        assert line["metrics"] and not any(
            "roofline" in k or "idle" in k or "mfu" in k for k in line["metrics"])


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    mods = {"repro_torch": 1, "repro_torch.core": 1, "jaxtyping": 1, "reprox": 1,
            "repro.core": 1, "jax": 1, "jaxlib.xla": 1, "flax": 1}
    assert guard.forbidden_modules(mods) == ["flax", "jax", "jaxlib.xla", "repro.core"]
    assert guard.forbidden_modules({"repro_torch": 1, "torch": 1}) == []
    monkeypatch.setitem(sys.modules, "repro", type(sys)("repro"))
    with pytest.raises(SystemExit) as e:
        guard.check("in a test")
    assert e.value.code == 3


def test_benchmark_sources_import_neither_jax_nor_the_jax_package():
    for path in PACKAGE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in guard.FORBIDDEN, (path, n)
                assert n.split(".")[0] != "benchmarks", (path, n)
        if "reference" in path.parts:
            assert "repro_torch" not in path.read_text(), path


def _break(monkeypatch, fault):
    import torch

    from repro_torch.kernels import fused_column

    if fault == "fit returns its state unchanged":
        monkeypatch.setattr(fused_column, "fit_scan_padded",
                            lambda w, *a, **k: w.to(torch.float32).clone())
        monkeypatch.setattr(fused_column, "fit_fused", lambda params, *a, **k: (
            {"w": params["w"].to(torch.float32).clone()}, None))
    elif fault == "an answer altered where it is produced":
        real = fused_column.assign_padded

        def altered(*a, **k):
            ids = real(*a, **k)
            ids[..., 0] = (ids[..., 0] + 1) % 2
            return ids

        monkeypatch.setattr(fused_column, "assign_padded", altered)
        from repro_torch.core import column

        real_ca = column.cluster_assignments

        def altered_ca(*a, **k):
            ids = real_ca(*a, **k).clone()
            ids[0] = (ids[0] + 1) % 2
            return ids

        monkeypatch.setattr(column, "cluster_assignments", altered_ca)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("fault", ["fit returns its state unchanged",
                                   "an answer altered where it is produced"])
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    _break(monkeypatch, fault)
    _, line = _run(tiny_root, cell)
    assert line["correct"] is False, (fault, line["checks"])


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_control_in_bfloat16_is_not_correct(tiny_root, cell):
    """The reference in bfloat16 put in the program's place fails one of
    the cell's numbers; here at a size a test can hold, with a cell cut
    to where bfloat16's 8-bit mantissa shows."""
    import torch

    from nspubench import control

    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    found = run.find_cell(manifest, cell, tiny_root)
    if found["traffic"]["generator"] != "explore":
        # integer weights: bfloat16 holds the potential exactly only up
        # to 256, so the tiny design's threshold (297.5) lies past it
        found["config"]["designs"] = [
            {"dataset": "ToeSegmentation2", "p": 343, "q": 2, "n_series": 120}]
        found["config"]["t_max"] = 64
        found["config"]["epochs"] = 4
    checks = control.readings(found, seed=7, seconds=0.3, device=torch.device("cpu"))
    assert any(v > lim for v, lim in checks.values()), checks
    assert np.isfinite([v for v, _ in checks.values()]).all()
