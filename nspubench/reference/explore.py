"""Reference of a design-space exploration: every candidate of the grid
trained, assigned and scored, its silicon forecast, and the Pareto set.

The candidates are the cross product of the axes in the order encoder,
q, t_max, threshold scale; candidate i of a job with seed s starts from
``tnn.dse_initial_weights(s, i, ...)``.  A candidate that assigns every
series to "unclustered" has no Rand index and is quarantined.  The
forecast is the paper's TNN7 regression on the synapse count (§III-D):
area 5.56 um^2 per synapse - 94.9, leakage 0.00541 uW per synapse -
0.725.  The Pareto set keeps the candidates no other candidate matches or
beats on Rand index (up), area and leakage (down) while beating it on
one, cheapest area first.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from nspubench.reference import tnn


@dataclasses.dataclass(frozen=True)
class Candidate:
    index: int
    q: int
    t_max: int
    scale: float
    encoder: str


def candidates(axes: dict) -> list[Candidate]:
    return [
        Candidate(i, q, t, s, e)
        for i, (e, q, t, s) in enumerate(itertools.product(
            axes["encoder"], axes["q"], axes["t_max"], axes["threshold_scale"]))
    ]


def width(length: int, encoder: str) -> int:
    return length if encoder == "latency" else 2 * length


def area_um2(synapses: int) -> float:
    return float(synapses) * 5.56 + (-94.9)


def leakage_uw(synapses: int) -> float:
    return float(synapses) * 0.00541 + (-0.725)


def pareto(points: dict) -> list[int]:
    """points {index: (rand index, area, leakage)} -> frontier indices."""
    ranked = {i: v for i, v in points.items() if not math.isnan(v[0])}

    def dominates(a, b):
        ge = a[0] >= b[0] and a[1] <= b[1] and a[2] <= b[2]
        gt = a[0] > b[0] or a[1] < b[1] or a[2] < b[2]
        return ge and gt

    front = [i for i, v in ranked.items()
             if not any(dominates(o, v) for j, o in ranked.items() if j != i)]
    return sorted(front, key=lambda i: (ranked[i][1], -ranked[i][0]))


def explore(series: np.ndarray, labels: np.ndarray, axes: dict, seeds: list,
            epochs: int, rule: tnn.Rule, device, dtype=torch.float32,
            fit_acc=torch.float32, assign_acc=torch.float64) -> dict:
    """Every candidate of ``axes`` for each job seed in ``seeds``.

    Returns {'jobs': [{'points': {index: dict(w, rand_index, area_um2,
    leakage_uw)}, 'silent': [index...], 'pareto': [index...]}...],
    'work': [{index: dict(fit=..., assign=..., p, q, n, steps)}...]} with
    the slope-form work of each candidate's fit and assignment."""
    x = torch.as_tensor(np.asarray(series), dtype=torch.float32).to(device)
    n, length = x.shape
    cands = candidates(axes)
    k = len(seeds)
    jobs = [{"points": {}, "silent": [], "pareto": []} for _ in range(k)]
    work = [{} for _ in range(k)]
    for encoder in dict.fromkeys(c.encoder for c in cands):
        group = [c for c in cands if c.encoder == encoder]
        p = width(length, encoder)
        q_env = max(c.q for c in group)
        window = max(c.t_max for c in group)
        enc = torch.stack([tnn.encode(x, c.t_max, encoder) for c in group])  # [C, N, p]
        thr = [np.float32(c.scale * tnn.suggest_threshold(p, rule.w_max)) for c in group]
        rows = torch.arange(len(group), device=device).repeat(k)              # [k*C]
        ds = tnn.Designs.of(thr * k, [c.t_max for c in group] * k,
                            [c.q for c in group] * k, [p] * (k * len(group)), device)
        w0 = torch.zeros((k * len(group), p, q_env), dtype=dtype)
        for j, s in enumerate(seeds):
            for ci, c in enumerate(group):
                w0[j * len(group) + ci, :, : c.q] = tnn.dse_initial_weights(
                    s, c.index, p, c.q, rule.w_max).to(dtype)
        w, fit_work, steps = tnn.fold(w0.to(device), enc, ds, rule, epochs, window,
                                      acc=fit_acc, rows=rows)
        for j in range(k):
            mine = torch.arange(j * len(group), (j + 1) * len(group), device=device)
            ds_j = ds.take(mine)
            t, asg_work = tnn.fire_dense(w[mine], enc, ds_j, window, acc=assign_acc)
            ids = tnn.ids_from_times(t, ds_j).cpu().numpy()
            for ci, c in enumerate(group):
                d = j * len(group) + ci
                syn = p * c.q
                work[j][c.index] = dict(
                    p=p, q=c.q, n=n, steps=int(steps[d]),
                    fit=(int(fit_work.up[d]), int(fit_work.down[d]), int(fit_work.cycles[d])),
                    assign=(int(asg_work.up[ci]), int(asg_work.down[ci]),
                            int(asg_work.cycles[ci])))
                if np.all(ids[ci] == c.q):
                    jobs[j]["silent"].append(c.index)
                    continue
                jobs[j]["points"][c.index] = dict(
                    w=w[d, :, : c.q].float().cpu().numpy(),
                    rand_index=tnn.rand_index(labels, ids[ci]),
                    area_um2=area_um2(syn), leakage_uw=leakage_uw(syn))
    for job in jobs:
        job["pareto"] = pareto({i: (v["rand_index"], v["area_um2"], v["leakage_uw"])
                                for i, v in job["points"].items()})
        job["silent"].sort()
    return {"jobs": jobs, "work": work}
