"""Closed loop of Table II jobs: each job trains and assigns every design
of the configuration in turn with ``simulator.cluster_time_series`` from
integer initial weights of its own, until the window's seconds have
passed.

Traffic parameters: ``check_jobs`` (jobs of an untraced run drawn from
the seed for the comparison; a traced run compares all) and ``pool``
(jobs whose initial weights set-up draws on the card, one call a design).
"""
from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from nspubench import data
from nspubench.generators import BF16, column_config, derived_seed, max_abs, rule_of
from nspubench.reference import fit as ref
from nspubench.reference import tnn
from nspubench.roofline import fire_ops, stdp_ops

LIMITS = {
    # integer weights and integer STDP steps: every comparison is exact
    "ids_mismatch": 0,
    "w_max_abs_diff": 0.0,
    "rand_index_max_abs_diff": 0.0,
}


def table2_designs(cfg: dict, seed: int) -> list:
    """The configuration's designs with their data and threshold."""
    w_max = int(cfg["neuron"]["w_max"])
    out = []
    for k, d in enumerate(cfg["designs"]):
        x, y = data.stream(d["dataset"], derived_seed(seed, 1, k), int(d["n_series"]),
                           int(d["p"]))
        out.append(dict(name=d["dataset"], series=x, labels=y, p=int(d["p"]), q=int(d["q"]),
                        t_max=int(cfg["t_max"]),
                        threshold=tnn.suggest_threshold(int(d["p"]), w_max)))
    return out


def integer_weights(designs: list, count: int, seed: int, w_max: int, device) -> list:
    """[count, p, q] float32 weights uniform over 0..w_max per design,
    drawn on ``device`` in one call a design."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randint(0, w_max + 1, (count, d["p"], d["q"]), generator=gen,
                          device=device).to(torch.float32) for d in designs]


class Generator:
    def __init__(self, config: dict, traffic: dict, seed: int, device, seconds: float):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.epochs = int(config["epochs"])
        self.outputs: list = []
        self.elapsed = 0.0

    def setup(self) -> None:
        self.designs = table2_designs(self.cfg, self.seed)
        self.cfgs = [column_config(self.cfg, d["p"], d["q"], d["t_max"], d["threshold"])
                     for d in self.designs]
        w_max = int(self.cfg["neuron"]["w_max"])
        self.pool = integer_weights(self.designs, int(self.traffic["pool"]),
                                    derived_seed(self.seed, 4), w_max, self.device)
        warm = integer_weights(self.designs, 1, derived_seed(self.seed, 5), w_max, self.device)
        self.sim = importlib.import_module("repro_torch.core.simulator")
        self._job([w[0] for w in warm])

    def _job(self, w0: list) -> list:
        out = []
        for d, c, w in zip(self.designs, self.cfgs, w0):
            r = self.sim.cluster_time_series(d["series"], d["labels"], c, epochs=self.epochs,
                                             params={"w": w}, device=self.device)
            out.append((r.assignments, r.rand_index, r.params["w"]))
        return out

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            j = len(self.outputs) % self.pool[0].shape[0]
            self.outputs.append((j, self._job([w[j] for w in self.pool])))
        self.elapsed = time.perf_counter() - t0

    def summary(self) -> dict:
        designs = len(self.designs) * len(self.outputs)
        return dict(metrics={"designs_per_s": designs / self.elapsed},
                    attempted=designs, failed=0,
                    work={"designs": designs, "jobs": len(self.outputs),
                          "window_s": self.elapsed})

    def release(self) -> None:
        self.sim = None

    def plan_control(self, seconds: float) -> None:
        self.designs = table2_designs(self.cfg, self.seed)
        w_max = int(self.cfg["neuron"]["w_max"])
        k = int(self.traffic["check_jobs"])
        self.pool = integer_weights(self.designs, k, derived_seed(self.seed, 4), w_max,
                                    self.device)
        self.outputs = [(j, None) for j in range(k)]

    def check(self, full: bool, control: bool = False) -> dict:
        n = len(self.outputs)
        if full or control:
            pick = list(range(n))
        else:
            rng = np.random.default_rng(derived_seed(self.seed, 9))
            pick = sorted(rng.choice(n, min(n, int(self.traffic["check_jobs"])),
                                     replace=False).tolist())
        rows = torch.as_tensor([self.outputs[i][0] for i in pick], device=self.device)
        w0 = [w[rows] for w in self.pool]
        rule, window = rule_of(self.cfg), int(self.cfg["t_max"])
        want = ref.fit_grid(self.designs, w0, self.epochs, rule, window, self.device)
        if control:
            alt = ref.fit_grid(self.designs, w0, self.epochs, rule, window, self.device, **BF16)
            got = [[(a["ids"][j], a["rand_index"][j], a["w"][j]) for a in alt]
                   for j in range(len(pick))]
        else:
            got = [self.outputs[i][1] for i in pick]
        c = dict.fromkeys(LIMITS, 0)
        for j, job in enumerate(got):
            for (ids, ri, w), wd in zip(job, want):
                c["ids_mismatch"] += int((np.asarray(ids) != wd["ids"][j]).sum())
                c["w_max_abs_diff"] = max(c["w_max_abs_diff"], max_abs(w, wd["w"][j]))
                c["rand_index_max_abs_diff"] = max(c["rand_index_max_abs_diff"],
                                                   abs(ri - wd["rand_index"][j]))
        fits, ops = [], 0
        for wd in want:
            for j in range(len(pick)):
                fits.append(dict(p=wd["p"], q=wd["q"], n=wd["n"], steps=wd["steps"],
                                 work=wd["fit"][j]))
                ops += (fire_ops(*wd["fit"][j]) + stdp_ops(wd["p"], wd["q"], wd["steps"])
                        + fire_ops(*wd["assign"][j]))
        return dict(checks={k: (c[k], LIMITS[k]) for k in LIMITS},
                    counts={"fused_step": fits, "ops": ops, "jobs": len(pick)})
