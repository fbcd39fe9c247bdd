"""Closed loop of one designer: back-to-back design-space explorations
(``repro_torch.dse.explore``) of one stream, each with a job seed drawn
from the run's seed, until the window's seconds have passed.

Traffic parameters: ``check_jobs``, the jobs of an untraced run drawn
from the seed for the comparison (a traced run compares them all, since
its roofline counts every job).
"""
from __future__ import annotations

import importlib
import time

import numpy as np

from nspubench import data
from nspubench.generators import BF16, derived_seed, max_abs, rule_of
from nspubench.reference import explore as ref
from nspubench.roofline import fire_ops, stdp_ops

LIMITS = {
    # every comparison is exact: the reference follows the same float32
    # operations, and the float64 assignment sums float32 terms exactly
    "quarantine_mismatch": 0,
    "w_max_abs_diff": 0.0,
    "rand_index_max_abs_diff": 0.0,
    "forecast_max_abs_diff": 0.0,
    "pareto_mismatch": 0,
}


class Generator:
    def __init__(self, config: dict, traffic: dict, seed: int, device, seconds: float):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.axes = config["axes"]
        self.epochs = int(config["epochs"])
        self.jobs: list = []          # (job seed, outputs)
        self.elapsed = 0.0

    def setup(self) -> None:
        self.x, self.y = data.stream(self.cfg["dataset"], derived_seed(self.seed, 1),
                                     int(self.cfg["n_series"]), int(self.cfg["length"]))
        self.mod = importlib.import_module("repro_torch.dse.explore")
        from repro_torch.dse.space import DesignSpace

        self.space = DesignSpace(**self.axes)
        self._job(derived_seed(self.seed, 2))

    def _job(self, job_seed: int):
        res = self.mod.explore(self.x, self.y, self.space, epochs=self.epochs,
                               seed=job_seed, device=self.device)
        return {
            "points": {p.index: dict(w=p.params["w"], rand_index=p.rand_index,
                                     area_um2=p.area_um2, leakage_uw=p.leakage_uw)
                       for p in res.points},
            "silent": sorted(f["index"] for f in res.meta["failures"]),
            "pareto": [p.index for p in res.pareto],
        }

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            js = derived_seed(self.seed, 3, len(self.jobs))
            self.jobs.append((js, self._job(js)))
        self.elapsed = time.perf_counter() - t0

    def summary(self) -> dict:
        per_job = len(ref.candidates(self.axes))
        designs = per_job * len(self.jobs)
        failed = sum(len(j["silent"]) for _, j in self.jobs)
        return dict(metrics={"designs_per_s": designs / self.elapsed},
                    attempted=designs, failed=failed,
                    work={"designs": designs, "jobs": len(self.jobs),
                          "window_s": self.elapsed})

    def release(self) -> None:
        self.mod = self.space = None

    def plan_control(self, seconds: float) -> None:
        """The jobs an untraced run would compare, without running them."""
        self.x, self.y = data.stream(self.cfg["dataset"], derived_seed(self.seed, 1),
                                     int(self.cfg["n_series"]), int(self.cfg["length"]))
        self.jobs = [(derived_seed(self.seed, 3, i), None)
                     for i in range(int(self.traffic["check_jobs"]))]

    def check(self, full: bool, control: bool = False) -> dict:
        n = len(self.jobs)
        if full or control:
            pick = list(range(n))
        else:
            rng = np.random.default_rng(derived_seed(self.seed, 9))
            pick = sorted(rng.choice(n, min(n, int(self.traffic["check_jobs"])),
                                     replace=False).tolist())
        seeds = [self.jobs[i][0] for i in pick]
        rule = rule_of(self.cfg)
        want = ref.explore(self.x, self.y, self.axes, seeds, self.epochs, rule, self.device)
        if control:
            got = ref.explore(self.x, self.y, self.axes, seeds, self.epochs, rule,
                              self.device, dtype=BF16["dtype"], fit_acc=BF16["acc"],
                              assign_acc=BF16["acc"])["jobs"]
        else:
            got = [self.jobs[i][1] for i in pick]
        c = dict.fromkeys(LIMITS, 0)
        for g, w in zip(got, want["jobs"]):
            c["quarantine_mismatch"] += len(set(g["silent"]) ^ set(w["silent"]))
            gp = list(g["pareto"])
            c["pareto_mismatch"] += len(set(gp) ^ set(w["pareto"])) or int(gp != w["pareto"])
            for idx, wp in w["points"].items():
                gpnt = g["points"].get(idx)
                if gpnt is None:
                    continue
                c["w_max_abs_diff"] = max(c["w_max_abs_diff"], max_abs(gpnt["w"], wp["w"]))
                c["rand_index_max_abs_diff"] = max(
                    c["rand_index_max_abs_diff"], abs(gpnt["rand_index"] - wp["rand_index"]))
                c["forecast_max_abs_diff"] = max(
                    c["forecast_max_abs_diff"], abs(gpnt["area_um2"] - wp["area_um2"]),
                    abs(gpnt["leakage_uw"] - wp["leakage_uw"]))
        fits, ops = [], 0
        for job in want["work"]:
            for item in job.values():
                fits.append(dict(p=item["p"], q=item["q"], n=item["n"],
                                 steps=item["steps"], work=item["fit"]))
                ops += (fire_ops(*item["fit"]) + stdp_ops(item["p"], item["q"], item["steps"])
                        + fire_ops(*item["assign"]))
        return dict(checks={k: (c[k], LIMITS[k]) for k in LIMITS},
                    counts={"fused_block": fits, "ops": ops, "jobs": len(pick)})
