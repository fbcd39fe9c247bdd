"""Fixtures of the benchmark's own tests: tiny cells written to a
temporary checkout, so that a cell is found from its files alone."""
from __future__ import annotations

import json
import pathlib
import sys

import pytest

SRC = str(pathlib.Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

TINY_CONFIGS = {
    "tiny-dse": {
        "dataset": "WordSynonyms", "length": 24, "n_series": 30, "epochs": 1,
        "axes": {"q": [3], "t_max": [8, 16], "threshold_scale": [1.0],
                 "encoder": ["latency", "onoff"]},
        "neuron": {"response": "rnl", "w_max": 7}, "wta": {"k": 1, "tie_break": "index"},
        "stdp": {"mu_capture": 0.5, "mu_backoff": 0.5, "mu_search": 0.0009765625,
                 "stabilizer": "half", "mode": "expected"},
    },
    "tiny-grid": {
        "designs": [{"dataset": "SonyAIBORobotSurface2", "p": 20, "q": 2, "n_series": 30},
                    {"dataset": "Beef", "p": 16, "q": 3, "n_series": 20}],
        "t_max": 16, "epochs": 1,
        "neuron": {"response": "rnl", "w_max": 7}, "wta": {"k": 1, "tie_break": "index"},
        "stdp": {"mu_capture": 1.0, "mu_backoff": 1.0, "mu_search": 1.0,
                 "stabilizer": "none", "mode": "expected"},
    },
}
TINY_TRAFFIC = {
    "tiny-explore": {"generator": "explore", "check_jobs": 1},
    "tiny-fit": {"generator": "fit", "check_jobs": 2, "pool": 8},
    "tiny-serve": {"generator": "serve", "rate_per_s": 1500.0, "batch_size": 4, "refit_every": 8,
                   "refit_window": 5, "refit_epochs": 1, "waste_cap": 4.0},
}
TINY_CELLS = {
    "tiny-dse.explore": ("tiny-dse", "tiny-explore", ["designs_per_s"]),
    "tiny-grid.fit": ("tiny-grid", "tiny-fit", ["designs_per_s"]),
    "tiny-grid.serve": ("tiny-grid", "tiny-serve",
                        ["serve_p50_ms", "serve_p95_ms", "served_per_s"]),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card with CUDA; skips on hosts without one")


@pytest.fixture
def tiny_root(tmp_path) -> pathlib.Path:
    """A checkout holding a manifest of the tiny cells, their
    configurations and traffic files, and the real manifest's metrics."""
    real = json.loads((pathlib.Path(__file__).resolve().parents[2] / "BENCHMARK.json")
                      .read_text())
    (tmp_path / "nspubench" / "configs").mkdir(parents=True)
    (tmp_path / "nspubench" / "traffic").mkdir()
    for name, cfg in TINY_CONFIGS.items():
        (tmp_path / "nspubench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, tr in TINY_TRAFFIC.items():
        (tmp_path / "nspubench" / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    cells = list(TINY_CELLS)
    manifest = {
        "configs": [{"name": n, "file": f"nspubench/configs/{n}.json"} for n in TINY_CONFIGS],
        "workloads": [{"name": c, "config": cfg, "traffic": tr, "chips": 1}
                      for c, (cfg, tr, _) in TINY_CELLS.items()],
        "end_to_end": [dict(m, workloads=cells) if m["name"] == "setup_s" else
                       dict(m, workloads=[c for c, v in TINY_CELLS.items() if m["name"] in v[2]])
                       for m in real["end_to_end"]],
        "per_layer": [dict(m, workloads=[
            "tiny-dse.explore" if w == "wordsynonyms-dse.explore" else
            "tiny-grid.fit" if w == "table2-grid.fit" else "tiny-grid.serve"
            for w in m["workloads"]]) for m in real["per_layer"]],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")
