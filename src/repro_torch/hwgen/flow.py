"""The TNNGen hardware process flow (paper Fig. 1, right half).

``run_flow`` takes a ``ColumnSpec`` through RTL generation -> TCL script
generation -> synthesis -> place-and-route, producing report files and a
``FlowResult``.  The *executor* is pluggable:

* ``CadenceExecutor`` shells out to Genus/Innovus using the generated TCL —
  the real TNNGen path; it raises immediately here (no EDA install).
* ``ModelExecutor`` (default) evaluates the analytical PDK silicon models
  fitted to the paper's own post-layout tables (see pdk.py), writes
  tool-style report files, and reports flow runtimes from the fitted
  runtime model.  A deterministic per-design jitter (seeded by the design
  hash) models P&R noise at the magnitude the paper's Table V residuals
  exhibit (~±2% for large designs).

This keeps every artifact of the real flow (RTL, TCL, reports, a design
database for forecasting) while substituting only the proprietary tool
execution, as discussed in DESIGN.md §2.


The port's own copy of the JAX package's ``hwgen/flow.py``: the same
``FlowResult`` for one spec, hash-seeded jitter included.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

from repro_torch.hwgen import pdk, rtl, tcl


@dataclasses.dataclass
class FlowResult:
    name: str
    library: str
    synapses: int
    area_um2: float
    leakage_uw: float
    latency_ns: float
    synth_runtime_s: float
    pnr_runtime_s: float
    total_runtime_s: float
    build_dir: Optional[str]
    stats: dict

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        return d


class CadenceExecutor:
    """Shells out to the Cadence toolchain (requires a licensed install)."""

    def run(self, spec: rtl.ColumnSpec, library: str, build_dir: str) -> FlowResult:
        raise RuntimeError(
            "Cadence Genus/Innovus are not available in this environment; "
            "use ModelExecutor (see DESIGN.md §2)."
        )


class ModelExecutor:
    """Analytical EDA executor fitted to the paper's published results."""

    def __init__(self, jitter: float = 0.02, seed: int = 0):
        self.jitter = jitter
        self.seed = seed

    def _jitter(self, spec: rtl.ColumnSpec, library: str, what: str) -> float:
        h = hashlib.sha256(
            f"{spec.name}/{spec.p}x{spec.q}/{library}/{what}/{self.seed}".encode()
        ).digest()
        u = int.from_bytes(h[:8], "little") / 2**64  # [0, 1)
        return 1.0 + self.jitter * (2.0 * u - 1.0)

    def run(self, spec: rtl.ColumnSpec, library: str, build_dir: str) -> FlowResult:
        model = pdk.MODELS[library]
        s = spec.synapse_count
        area = model.area_um2(s) * self._jitter(spec, library, "area")
        leak = model.leakage_uw(s) * self._jitter(spec, library, "leak")
        lat = pdk.latency_model_ns(spec.p, spec.q)
        synth_s = model.synth_runtime_s(s) * self._jitter(spec, library, "synth")
        pnr_s = model.pnr_runtime_s(s) * self._jitter(spec, library, "pnr")
        stats = rtl.netlist_stats(spec)

        if build_dir:
            rep = os.path.join(build_dir, "reports")
            os.makedirs(rep, exist_ok=True)
            top = f"tnn_column_{spec.name}"
            with open(os.path.join(rep, f"{top}_{library}_pnr_summary.rpt"), "w") as f:
                f.write(
                    "# post-P&R summary (ModelExecutor — fitted to paper tables)\n"
                    f"design        : {top}\nlibrary       : {library}\n"
                    f"synapses      : {s}\nflops         : {stats['flops']}\n"
                    f"total area    : {area:.3f} um^2\n"
                    f"leakage power : {leak:.4f} uW\n"
                    f"comp latency  : {lat:.2f} ns\n"
                    f"synth runtime : {synth_s:.1f} s\npnr runtime   : {pnr_s:.1f} s\n"
                )
        return FlowResult(
            name=spec.name, library=library, synapses=s,
            area_um2=area, leakage_uw=leak, latency_ns=lat,
            synth_runtime_s=synth_s, pnr_runtime_s=pnr_s,
            total_runtime_s=synth_s + pnr_s, build_dir=build_dir, stats=stats,
        )


def run_flow(
    spec: rtl.ColumnSpec,
    library: str = "tnn7",
    build_root: Optional[str] = None,
    executor=None,
    write_rtl: bool = True,
) -> FlowResult:
    """PyTorch-model-spec -> RTL -> TCL -> synthesis -> P&R (paper Fig. 1).

    Returns the post-layout metrics; writes RTL, flow scripts and reports
    under ``build_root/<name>/`` when a build root is given.
    """
    if library not in pdk.LIBRARIES:
        raise ValueError(f"unknown library {library!r}; choose from {pdk.LIBRARIES}")
    executor = executor or ModelExecutor()
    build_dir = None
    if build_root:
        build_dir = os.path.join(build_root, f"{spec.name}_{library}")
        os.makedirs(build_dir, exist_ok=True)
        if write_rtl:
            for fname, text in rtl.generate_column(spec).items():
                with open(os.path.join(build_dir, fname), "w") as f:
                    f.write(text)
            for fname, text in tcl.generate_flow_scripts(spec, library).items():
                with open(os.path.join(build_dir, fname), "w") as f:
                    f.write(text)
    result = executor.run(spec, library, build_dir)
    if build_dir:
        with open(os.path.join(build_dir, "flow_result.json"), "w") as f:
            json.dump(result.to_json(), f, indent=2)
    return result


def run_design_sweep(
    specs: list,
    libraries=pdk.LIBRARIES,
    build_root: Optional[str] = None,
    executor=None,
) -> list:
    """Run the full flow for a sweep of designs x libraries (the paper's
    Tables III/IV loop); returns a flat list of FlowResults and appends them
    to the forecasting design database."""
    results = []
    for spec in specs:
        for lib in libraries:
            results.append(run_flow(spec, lib, build_root, executor))
    return results
