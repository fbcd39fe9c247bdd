"""Reference of the Table II experiment: each design's column trained
online over its stream for a number of epochs from the given weights,
then every series assigned to its earliest-firing neuron, and the Rand
index against the labels."""
from __future__ import annotations

import numpy as np
import torch

from nspubench.reference import tnn


def fit_grid(designs: list, w0: list, epochs: int, rule: tnn.Rule, window: int,
             device, dtype=torch.float32, acc=torch.float32) -> list:
    """designs: [dict(series [N, L], labels [N], q, t_max, threshold)];
    w0: one [K, p, q] tensor per design (K jobs).  Returns per design a
    dict(w [K, p, q], ids [K, N], rand_index [K], fit / assign work
    (up, down, cycles) [K] each, steps).  Designs of one q fold together."""
    out = [None] * len(designs)
    for q in dict.fromkeys(d["q"] for d in designs):
        idx = [i for i, d in enumerate(designs) if d["q"] == q]
        for i, r in zip(idx, _fit_group([designs[i] for i in idx], [w0[i] for i in idx],
                                        epochs, rule, window, device, dtype, acc)):
            out[i] = r
    return out


def _fit_group(designs, w0, epochs, rule, window, device, dtype, acc) -> list:
    k = w0[0].shape[0]
    nd = len(designs)
    enc = [tnn.encode(torch.as_tensor(np.asarray(d["series"]), dtype=torch.float32)
                      .to(device), d["t_max"], "latency") for d in designs]
    p_env = max(e.shape[1] for e in enc)
    q_env = max(d["q"] for d in designs)
    n_env = max(e.shape[0] for e in enc)
    vol = torch.full((nd, n_env, p_env), window, dtype=torch.int64, device=device)
    real = torch.zeros((nd * k, n_env), dtype=torch.bool, device=device)
    for i, e in enumerate(enc):
        vol[i, : e.shape[0], : e.shape[1]] = e
        real[i * k : (i + 1) * k, : e.shape[0]] = True
    w = torch.zeros((nd * k, p_env, q_env), dtype=dtype, device=device)
    for i, d in enumerate(designs):
        w[i * k : (i + 1) * k, : enc[i].shape[1], : d["q"]] = w0[i].to(device, dtype)
    rows = torch.arange(nd, device=device).repeat_interleave(k)
    ds = tnn.Designs.of(
        np.repeat([np.float32(d["threshold"]) for d in designs], k),
        np.repeat([d["t_max"] for d in designs], k),
        np.repeat([d["q"] for d in designs], k),
        np.repeat([e.shape[1] for e in enc], k), device)
    w, fit_work, steps = tnn.fold(w, vol, ds, rule, epochs, window, real=real,
                                  acc=acc, rows=rows)
    g = torch.round(torch.clamp(w, 0.0, float(rule.w_max)))
    times = []
    asg = tnn.FireStats.zeros(nd * k, device)
    for i in range(n_env):
        t, st = tnn.fire_grid(g, vol[rows, i], ds, window, rule.w_max, acc)
        times.append(t)
        asg.add(st, real[:, i].to(torch.int64))
    ids = tnn.ids_from_times(torch.stack(times, dim=1), ds).cpu().numpy()
    out = []
    for i, d in enumerate(designs):
        n, p = enc[i].shape
        sl = slice(i * k, (i + 1) * k)
        out.append(dict(
            w=w[sl, :p, : d["q"]], ids=ids[sl, :n],
            rand_index=[tnn.rand_index(d["labels"], ids[j, :n]) for j in range(i * k, (i + 1) * k)],
            fit=[(int(fit_work.up[j]), int(fit_work.down[j]), int(fit_work.cycles[j]))
                 for j in range(i * k, (i + 1) * k)],
            assign=[(int(asg.up[j]), int(asg.down[j]), int(asg.cycles[j]))
                    for j in range(i * k, (i + 1) * k)],
            steps=int(steps[i * k]), p=p, q=d["q"], n=n))
    return out
