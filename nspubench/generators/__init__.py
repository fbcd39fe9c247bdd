"""The general generators: one per kind of traffic (``generator`` in a
traffic file).  A generator sets up the cell from its configuration and
traffic parameters and the run's seed, warms the cell's own shapes, runs
the measured window, and compares what the window produced with the
reference.

Every generator has the same surface: ``Generator(config, traffic, seed,
device)``, ``setup()``, ``window(seconds)``, ``summary()`` -> dict(metrics,
attempted, failed, work), ``release()`` (drop the program's state, keep
its outputs), ``check(full, control=False)`` -> dict(checks {name:
(value, limit)}, counts {kernel: [items], 'ops': total operations}).
With ``control`` the program's outputs are replaced by the reference's
in bfloat16 (weights and potential), the precision below the
configuration's float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from nspubench.reference import tnn

BF16 = dict(dtype=torch.bfloat16, acc=torch.bfloat16)


def derived_seed(seed: int, *path: int) -> int:
    """A 31-bit seed derived from the run's seed and a path of indices."""
    return int(np.random.SeedSequence([int(seed) % 2**63, int(seed) >> 63, *path])
               .generate_state(1)[0]) >> 1


def rule_of(cfg: dict) -> tnn.Rule:
    s = cfg["stdp"]
    return tnn.Rule(float(s["mu_capture"]), float(s["mu_backoff"]), float(s["mu_search"]),
                    s["stabilizer"] == "half", int(cfg["neuron"]["w_max"]),
                    int(cfg["wta"]["k"]))


def column_config(cfg: dict, p: int, q: int, t_max: int, threshold: float):
    """The program's ``ColumnConfig`` of one design of a configuration."""
    from repro_torch.core.types import ColumnConfig, NeuronConfig, STDPConfig, WTAConfig

    n, s, w = cfg["neuron"], cfg["stdp"], cfg["wta"]
    return ColumnConfig(
        p=p, q=q, t_max=t_max,
        neuron=NeuronConfig(response=n["response"], threshold=float(threshold),
                            w_max=int(n["w_max"])),
        wta=WTAConfig(k=int(w["k"]), tie_break=w["tie_break"]),
        stdp=STDPConfig(mu_capture=float(s["mu_capture"]), mu_backoff=float(s["mu_backoff"]),
                        mu_search=float(s["mu_search"]), stabilizer=s["stabilizer"],
                        mode=s["mode"]),
    )


def max_abs(a, b) -> float:
    """Largest absolute difference of two arrays or tensors (inf where
    their shapes differ)."""
    a, b = (np.asarray(v.detach().double().cpu() if torch.is_tensor(v) else v, np.float64)
            for v in (a, b))
    if a.shape != b.shape:
        return math.inf
    return float(np.abs(a - b).max()) if a.size else 0.0


def quantile(values: list, q: float) -> float:
    """Nearest-rank quantile: the smallest value with at least a fraction
    q of the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]
