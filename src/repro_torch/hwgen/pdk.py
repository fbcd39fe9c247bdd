"""Process design kit (PDK) models: FreePDK45, ASAP7, TNN7.

The real TNNGen invokes Cadence Genus/Innovus against these libraries.  That
toolchain is proprietary and unavailable offline, so this module carries the
paper's *own measured results* (Tables III and IV — post-place-and-route
leakage and die area for the seven UCR column designs) as anchor
points, plus least-squares linear models fitted to them.  ``flow.py`` uses
these models as its analytical "EDA executor"; the paper itself demonstrates
(Table V, Fig. 4) that silicon area/leakage of these designs is linear in
synapse count, which is what makes this substitution faithful.

All areas in um^2; leakage in uW (FreePDK45 values are reported by the paper
in mW and converted here); runtimes in seconds.


The port's own copy of the JAX package's ``hwgen/pdk.py``: the same
anchor points and models.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# (benchmark, synapse_count) in paper order.
PAPER_DESIGNS = (
    ("SonyAIBORobotSurface2", 130),
    ("ECG200", 192),
    ("Wafer", 304),
    ("ToeSegmentation2", 686),
    ("Lightning2", 1274),
    ("Beef", 2350),
    ("WordSynonyms", 6750),
)

# Table IV: post-P&R die area (um^2) per library.
PAPER_AREA = {
    "freepdk45": (14284.466, 21036.08, 33868.98, 75654.82, 140502.84, 259167.4, 744422.4),
    "asap7": (1028.67, 1513.05, 2394.01, 5388.72, 10184.45, 18298.1, 51158.20),
    "tnn7": (692.06, 1015.8, 1608.52, 3682.63, 6860.68, 12634.83, 35303.88),
}

# Table III: post-P&R leakage power (uW) per library.
PAPER_LEAKAGE = {
    "freepdk45": (299.0, 442.0, 717.0, 1590.0, 2950.0, 5452.0, 15660.0),  # mW -> uW
    "asap7": (0.961, 1.41, 2.26, 5.09, 9.81, 17.4, 46.69),
    "tnn7": (0.57, 0.84, 1.34, 3.14, 5.84, 11.06, 31.13),
}

# Fig. 2 / §III-B: computation latency (ns) for fitted columns, keyed by
# (p, q).  The paper reports these four points.
PAPER_LATENCY_NS = {
    (65, 2): 79.2,
    (96, 2): 93.36,
    (152, 2): 98.4,
    (270, 25): 180.0,
}

# §III-B: total (leakage + dynamic) power for the largest column, TNN7.
PAPER_TOTAL_POWER_LARGEST = {"tnn7": 67.0, "asap7": 47.0, "freepdk45": 15660.0}  # uW

LIBRARIES = ("freepdk45", "asap7", "tnn7")


def _linfit(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """Least-squares y = a*x + b."""
    a, b = np.polyfit(np.asarray(x, np.float64), np.asarray(y, np.float64), 1)
    return float(a), float(b)


@dataclasses.dataclass(frozen=True)
class LibraryModel:
    """Silicon model for one cell library.

    Area/leakage interpolate monotonically THROUGH the paper's seven
    post-layout anchor points (exact at the published designs) and
    extrapolate linearly outside with the end-segment slope — the paper's
    own Table V shows pure linear regression deviates up to ~30% for the
    smallest designs, so the flow "ground truth" uses the table itself; the
    *forecaster* (forecast.py) stays linear, reproducing those errors.
    ``area_per_syn``/``leak_per_syn`` keep the fitted slopes for reporting.
    """

    name: str
    cal_syn: tuple          # anchor synapse counts (ascending)
    cal_area: tuple         # um^2 at cal_syn
    cal_leak: tuple         # uW at cal_syn
    area_per_syn: float     # fitted um^2 / synapse (reporting)
    area_base: float
    leak_per_syn: float     # fitted uW / synapse (reporting)
    leak_base: float
    # runtime models (see flow.py for how they were fitted):
    synth_base_s: float
    synth_per_syn_s: float
    pnr_base_s: float
    pnr_per_syn_s: float

    def _interp(self, x: float, ys: tuple) -> float:
        xs = self.cal_syn
        if x <= xs[0]:
            slope = (ys[1] - ys[0]) / (xs[1] - xs[0])
            return max(ys[0] + slope * (x - xs[0]), 0.0)
        if x >= xs[-1]:
            slope = (ys[-1] - ys[-2]) / (xs[-1] - xs[-2])
            return ys[-1] + slope * (x - xs[-1])
        return float(np.interp(x, xs, ys))

    def area_um2(self, synapses: int) -> float:
        return self._interp(float(synapses), self.cal_area)

    def leakage_uw(self, synapses: int) -> float:
        return max(self._interp(float(synapses), self.cal_leak), 0.0)

    def synth_runtime_s(self, synapses: int) -> float:
        return self.synth_base_s + self.synth_per_syn_s * synapses

    def pnr_runtime_s(self, synapses: int) -> float:
        return self.pnr_base_s + self.pnr_per_syn_s * synapses


def _build_models() -> dict:
    syn = np.array([s for _, s in PAPER_DESIGNS], np.float64)
    models = {}
    # Runtime fit (absolute values are not machine-readable from
    # Fig. 3; the model is pinned to the paper's *stated* relations):
    #   - TNN7 logic synthesis is ~3x faster than ASAP7 ([8], confirmed §III-C)
    #   - TNN7 P&R averages ~32% faster than ASAP7 (Fig. 3)
    #   - total flow speedup reaches ~47% for the 6750-synapse design (§III-C)
    # Solving those constraints at syn=6750 gives ASAP7 synth ~1500 s and
    # P&R ~1965 s; linear-in-synapses with small bases.
    asap7_synth = (30.0, (1500.0 - 30.0) / 6750.0)
    asap7_pnr = (45.0, (1965.0 - 45.0) / 6750.0)
    runtime = {
        "freepdk45": (asap7_synth, (60.0, (2400.0 - 60.0) / 6750.0)),  # 45nm: denser netlist, slower P&R
        "asap7": (asap7_synth, asap7_pnr),
        "tnn7": (
            (asap7_synth[0] / 3.0, asap7_synth[1] / 3.0),
            (asap7_pnr[0] * 0.68, asap7_pnr[1] * 0.68),
        ),
    }
    for lib in LIBRARIES:
        a_slope, a_base = _linfit(syn, np.array(PAPER_AREA[lib]))
        l_slope, l_base = _linfit(syn, np.array(PAPER_LEAKAGE[lib]))
        (sb, ss), (pb, ps) = runtime[lib]
        models[lib] = LibraryModel(
            name=lib,
            cal_syn=tuple(float(s) for s in syn),
            cal_area=PAPER_AREA[lib],
            cal_leak=PAPER_LEAKAGE[lib],
            area_per_syn=a_slope, area_base=a_base,
            leak_per_syn=l_slope, leak_base=l_base,
            synth_base_s=sb, synth_per_syn_s=ss,
            pnr_base_s=pb, pnr_per_syn_s=ps,
        )
    return models


MODELS: dict = _build_models()


def latency_model_ns(p: int, q: int) -> float:
    """Computation latency model, log-linear in synapse count.

    Fit to the paper's four reported latencies (Fig. 2 + §III-B); the
    microarchitecture's latency is dominated by the temporal wavefront
    traversal, which grows sub-linearly with column size.
    """
    pts = sorted((pp * qq, ns) for (pp, qq), ns in PAPER_LATENCY_NS.items())
    x = np.log([s for s, _ in pts])
    y = np.array([ns for _, ns in pts])
    b, a = np.polyfit(x, y, 1)
    return float(a + b * np.log(max(p * q, 2)))
