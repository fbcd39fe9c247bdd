"""Silicon-metric forecasting (paper §III-D) and its roofline generalization.

The paper trains linear-regression models on accumulated TNNGen flow runs so
that users without EDA access can predict post-layout area/leakage from the
synapse count alone:

    area_um2   = 5.56    * synapses - 94.9      (TNN7, 7 nm)
    leakage_uw = 0.00541 * synapses - 0.725     (TNN7, 7 nm)

``PaperForecaster`` carries those published coefficients verbatim;
``Forecaster`` refits the same model family from a design database of
``FlowResult`` runs (the paper: "trained on many TNNGen runs with varying
TNN sizes ... can be continually refined with more actual design data
points").

``RooflineForecaster`` is the beyond-paper generalization described in
DESIGN.md §5: the identical predict-silicon-from-size idea applied to the LM
dry-run — it regresses the compiled roofline terms (compute/memory/
collective seconds) on analytic model descriptors (params, FLOPs/token,
bytes moved), so new configs get cost estimates without re-lowering.


The port's own copy of the JAX package's ``hwgen/forecast.py``: the same
coefficients and fits.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np


def _lstsq(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    coef, *_ = np.linalg.lstsq(
        np.concatenate([X, np.ones((len(X), 1))], axis=1), y, rcond=None
    )
    return coef  # [k + 1] with intercept last


@dataclasses.dataclass
class LinearModel:
    coef: np.ndarray  # [k]
    intercept: float

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, np.float64))
        return X @ self.coef + self.intercept

    @classmethod
    def fit(cls, X: np.ndarray, y: np.ndarray) -> "LinearModel":
        c = _lstsq(np.atleast_2d(np.asarray(X, np.float64)), np.asarray(y, np.float64))
        return cls(coef=c[:-1], intercept=float(c[-1]))


# --- paper §III-D verbatim coefficients (TNN7) -------------------------------
PAPER_AREA_MODEL = LinearModel(coef=np.array([5.56]), intercept=-94.9)
PAPER_LEAKAGE_MODEL = LinearModel(coef=np.array([0.00541]), intercept=-0.725)


class PaperForecaster:
    """Forecast TNN7 post-layout area/leakage with the paper's equations."""

    def area_um2(self, synapses: int) -> float:
        return float(PAPER_AREA_MODEL.predict([[synapses]])[0])

    def leakage_uw(self, synapses: int) -> float:
        return float(PAPER_LEAKAGE_MODEL.predict([[synapses]])[0])


class Forecaster:
    """Refittable forecaster over a design database of FlowResults."""

    def __init__(self):
        self.area_model: Optional[LinearModel] = None
        self.leak_model: Optional[LinearModel] = None
        self._rows: list = []

    def add_runs(self, results: Sequence) -> None:
        for r in results:
            self._rows.append((r.synapses, r.area_um2, r.leakage_uw, r.library))

    def fit(self, library: str = "tnn7") -> None:
        rows = [r for r in self._rows if r[3] == library]
        if len(rows) < 2:
            raise ValueError("need >= 2 design points to fit the forecaster")
        syn = np.array([[r[0]] for r in rows], np.float64)
        self.area_model = LinearModel.fit(syn, np.array([r[1] for r in rows]))
        self.leak_model = LinearModel.fit(syn, np.array([r[2] for r in rows]))

    def area_um2(self, synapses: int) -> float:
        if self.area_model is None:
            raise RuntimeError("fit() first")
        return float(self.area_model.predict([[synapses]])[0])

    def leakage_uw(self, synapses: int) -> float:
        if self.leak_model is None:
            raise RuntimeError("fit() first")
        return float(self.leak_model.predict([[synapses]])[0])

    @staticmethod
    def error_pct(forecast: float, actual: float) -> float:
        return 100.0 * (forecast - actual) / actual


class RooflineForecaster:
    """Beyond-paper: predict dry-run roofline terms from arch descriptors.

    Features per (arch, shape) cell: [params_B, flops_per_step_P,
    activation_bytes_G, seq_len_k].  Targets: the three roofline terms in
    seconds.  Fitted on the dry-run table (benchmarks/roofline.py) the same
    way the paper fits silicon models on flow runs.
    """

    TERMS = ("compute_s", "memory_s", "collective_s")

    def __init__(self):
        self.models: dict = {}

    def fit(self, feats: np.ndarray, targets: dict) -> None:
        for term in self.TERMS:
            self.models[term] = LinearModel.fit(feats, np.asarray(targets[term]))

    def predict(self, feats: np.ndarray) -> dict:
        if not self.models:
            raise RuntimeError("fit() first")
        return {t: self.models[t].predict(feats) for t in self.TERMS}

    def save(self, path: str) -> None:
        blob = {
            t: {"coef": m.coef.tolist(), "intercept": m.intercept}
            for t, m in self.models.items()
        }
        with open(path, "w") as f:
            json.dump(blob, f, indent=2)

    @classmethod
    def load(cls, path: str) -> "RooflineForecaster":
        with open(path) as f:
            blob = json.load(f)
        fc = cls()
        for t, m in blob.items():
            fc.models[t] = LinearModel(np.asarray(m["coef"]), m["intercept"])
        return fc
