"""Open loop into one streaming clustering service
(``repro_torch.serve.ClusteringService``) holding the configuration's
designs.

Requests arrive as a Poisson process at the fixed ``rate_per_s`` over the
window; each picks its design uniformly and a series of that design's
stream uniformly.  The generator submits each request at its due time, or
as soon as the service returns control when it runs late, until every
request due in the window was submitted, then flushes.  A request is
timed from its due time to the return of the call in which its batch
completed; the generator's lateness is the time from due to submit.
Traffic parameters: ``rate_per_s``, ``batch_size``, ``refit_every``,
``refit_window``, ``refit_epochs``, ``waste_cap``.
"""
from __future__ import annotations

import math
import time

import numpy as np

from nspubench.generators import BF16, column_config, derived_seed, max_abs, quantile, rule_of
from nspubench.generators.fit import integer_weights, table2_designs
from nspubench.reference import serve as ref
from nspubench.roofline import fire_ops, stdp_ops

LIMITS = {
    # integer weights, integer STDP steps: every comparison is exact
    "failed": 0,
    "ids_mismatch": 0,
    "w_max_abs_diff": 0.0,
}
# a request that failed, was shed or rejected counts as this late
NEVER_S = 1e9


class Generator:
    def __init__(self, config: dict, traffic: dict, seed: int, device, seconds: float):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.seconds = float(seconds)

    def _arrivals(self) -> None:
        rng = np.random.default_rng(derived_seed(self.seed, 6))
        rate = float(self.traffic["rate_per_s"])
        n = int(rate * self.seconds * 1.2 + 64)
        due = np.cumsum(rng.exponential(1.0 / rate, n))
        while due[-1] < self.seconds:
            due = np.concatenate([due, due[-1] + np.cumsum(rng.exponential(1.0 / rate, n))])
        self.due = due[due < self.seconds]
        k = len(self.due)
        self.design_of = rng.integers(0, len(self.designs), k)
        sizes = np.asarray([len(d["labels"]) for d in self.designs])
        self.index_of = (rng.random(k) * sizes[self.design_of]).astype(np.int64)

    def setup(self) -> None:
        from repro_torch.serve import ClusteringService

        self.designs = table2_designs(self.cfg, self.seed)
        w_max = int(self.cfg["neuron"]["w_max"])
        self.w0 = [w[0].cpu().numpy() for w in integer_weights(
            self.designs, 1, derived_seed(self.seed, 4), w_max, self.device)]
        t = self.traffic
        self.svc = ClusteringService(
            {d["name"]: column_config(self.cfg, d["p"], d["q"], d["t_max"], d["threshold"])
             for d in self.designs},
            batch_size=int(t["batch_size"]), refit_every=int(t["refit_every"]),
            refit_window=int(t["refit_window"]), refit_epochs=int(t["refit_epochs"]),
            waste_cap=float(t["waste_cap"]),
            weights={d["name"]: w for d, w in zip(self.designs, self.w0)},
            device=self.device)
        self.svc.warmup()
        self._arrivals()

    def window(self, seconds: float) -> None:
        from repro_torch.serve import ServeResult

        svc, names = self.svc, [d["name"] for d in self.designs]
        series = [d["series"] for d in self.designs]
        n = len(self.due)
        self.late = np.zeros(n)
        self.done_at = np.full(n, math.nan)
        # the id each request was served, -1 where it failed, was shed or
        # refused; a handle is dropped once its request completed
        self.ids = np.full(n, -1, np.int64)
        outstanding: list = []

        def complete(t):
            keep = []
            for i, h in outstanding:
                if h.done:
                    self.done_at[i] = t - t0
                    if isinstance(h.outcome, ServeResult):
                        self.ids[i] = h.outcome.cluster
                else:
                    keep.append((i, h))
            return keep

        t0 = time.perf_counter()
        for i in range(n):
            due = t0 + self.due[i]
            now = time.perf_counter()
            if due - now > 0.002:
                time.sleep(due - now - 0.001)
            while now < due:
                now = time.perf_counter()
            self.late[i] = now - due
            d = self.design_of[i]
            try:
                h = svc.submit(series[d][self.index_of[i]], names[d])
            except Exception:  # noqa: BLE001 - a refused request counts as failed
                continue
            outstanding.append((i, h))
            if h.done:
                outstanding = complete(time.perf_counter())
        svc.flush()
        t = time.perf_counter()
        outstanding = complete(t)
        self.elapsed = t - t0

    def summary(self) -> dict:
        n = len(self.due)
        served = self.ids >= 0
        lat = np.where(served, self.done_at - self.due, NEVER_S).tolist()
        return dict(
            metrics={"serve_p50_ms": 1e3 * quantile(lat, 0.5),
                     "serve_p95_ms": 1e3 * quantile(lat, 0.95),
                     "served_per_s": int(served.sum()) / self.elapsed},
            attempted=n, failed=n - int(served.sum()),
            work={"requests": n, "window_s": self.elapsed, "latency_s": lat,
                  "lateness_s": self.late.tolist()})

    def release(self) -> None:
        self.final = [self.svc.weights(d["name"]) for d in self.designs]
        self.svc = None

    def plan_control(self, seconds: float) -> None:
        self.designs = table2_designs(self.cfg, self.seed)
        w_max = int(self.cfg["neuron"]["w_max"])
        self.w0 = [w[0].cpu().numpy() for w in integer_weights(
            self.designs, 1, derived_seed(self.seed, 4), w_max, self.device)]
        self._arrivals()

    def _replay(self, **prec) -> dict:
        t = self.traffic
        reqs = list(zip(self.design_of.tolist(), self.index_of.tolist()))
        return ref.replay(self.designs, self.w0, reqs, batch_size=int(t["batch_size"]),
                          refit_every=int(t["refit_every"]),
                          refit_window=int(t["refit_window"]),
                          refit_epochs=int(t["refit_epochs"]),
                          waste_cap=float(t["waste_cap"]), rule=rule_of(self.cfg),
                          device=self.device, **prec)

    def check(self, full: bool, control: bool = False) -> dict:
        want = self._replay()
        if control:
            alt = self._replay(**BF16)
            got_ids, got_w, failed = alt["ids"], alt["weights"], 0
        else:
            got_ids = self.ids
            got_w, failed = self.final, int((got_ids < 0).sum())
        served = got_ids >= 0
        checks = {
            "failed": failed,
            "ids_mismatch": int((got_ids[served] != want["ids"][served]).sum()),
            "w_max_abs_diff": max(max_abs(g, w) for g, w in zip(got_w, want["weights"])),
        }
        shapes = want["shapes"]
        batches = [dict(designs=[shapes[d][:2] for d in want["buckets"][b][1]],
                        requests=[(*shapes[self.design_of[r]][:2], *want["fire"][r])
                                  for r in reqs])
                   for b, reqs in want["batches"]]
        ops = (sum(fire_ops(*f) for f in want["fire"]) + fire_ops(*want["refit_work"])
               + sum(stdp_ops(shapes[d][0], shapes[d][1], s)
                     for d, s in enumerate(want["refit_steps"])))
        return dict(checks={k: (checks[k], LIMITS[k]) for k in LIMITS},
                    counts={"fire_block": batches, "ops": ops})
