"""Reference replay of the streaming clustering service in request order.

The service's semantics, as its documentation states them: designs pack
into shared envelopes, greedily from the largest fire volume p * q *
t_max down, a design joining the first bucket whose grown envelope keeps
every member within ``waste_cap`` times its own volume.  A bucket's
requests, in submission order, form batches of ``batch_size`` (the last,
flushed at the end, may be short); a batch is assigned with the weights
of that moment.  After a batch, once ``refit_every`` requests of the
bucket were served since its last re-fit, every design of the bucket
trains ``refit_epochs`` online passes over the last ``refit_window``
series it served since then, in arrival order, and the buffers empty.

With no deadlines and no queue bound this is a function of the request
order alone.  A design's weights only ever change at its re-fits, each
starting where the previous one ended, so its whole history is one online
fold over its re-fit windows laid end to end; the replay folds every
design at once and keeps the weights after each window.
"""
from __future__ import annotations

import numpy as np
import torch

from nspubench.reference import tnn


def envelope_buckets(shapes: list, waste_cap: float) -> list:
    vols = [p * q * t for (p, q, t) in shapes]
    buckets: list = []
    for i in sorted(range(len(shapes)), key=lambda i: -vols[i]):
        p, q, t = shapes[i]
        for bi, (env, members) in enumerate(buckets):
            cand = (max(env[0], p), max(env[1], q), max(env[2], t))
            vol = cand[0] * cand[1] * cand[2]
            if all(vol <= waste_cap * vols[m] for m in members + [i]):
                buckets[bi] = (cand, members + [i])
                break
        else:
            buckets.append(((p, q, t), [i]))
    return buckets


def schedule(design_of: np.ndarray, bucket_of: list, n_buckets: int, batch_size: int,
             refit_every: int, refit_window: int, refit_epochs: int) -> dict:
    """Batches, re-fits and the weights each request is assigned with.

    Returns dict(batches [(bucket, [request...])], refits [(bucket,
    {design: [request...]})], ck [R] (re-fits of its bucket before each
    request's batch), seq {design: [request...]} (its re-fit windows end
    to end, each ``refit_epochs`` times), ends {design: [position after
    each re-fit]})."""
    nd = len(bucket_of)
    by_bucket = [[] for _ in range(n_buckets)]
    for r, d in enumerate(design_of):
        by_bucket[bucket_of[d]].append(r)
    members = [[d for d in range(nd) if bucket_of[d] == b] for b in range(n_buckets)]
    ck = np.zeros(len(design_of), np.int64)
    seq = {d: [] for d in range(nd)}
    ends = {d: [] for d in range(nd)}
    batches, refits = [], []
    for b, reqs in enumerate(by_bucket):
        served, n_refits = 0, 0
        buffers = {d: [] for d in members[b]}
        for s in range(0, len(reqs), batch_size):
            chunk = reqs[s : s + batch_size]
            batches.append((b, chunk))
            ck[chunk] = n_refits
            served += len(chunk)
            for r in chunk:
                buf = buffers[int(design_of[r])]
                buf.append(r)
                del buf[: max(0, len(buf) - refit_window)]
            if refit_every > 0 and served >= refit_every and any(buffers.values()):
                refits.append((b, {d: list(v) for d, v in buffers.items()}))
                for d, buf in buffers.items():
                    seq[d].extend(buf * refit_epochs)
                    ends[d].append(len(seq[d]))
                    buf.clear()
                n_refits += 1
                served = 0
    return dict(batches=batches, refits=refits, ck=ck, seq=seq, ends=ends)


def replay(designs: list, w0: list, requests: list, *, batch_size: int,
           refit_every: int, refit_window: int, refit_epochs: int, waste_cap: float,
           rule: tnn.Rule, device, dtype=torch.float32, acc=torch.float32) -> dict:
    """designs: [dict(series [N, L], q, t_max, threshold)] in the service's
    order; w0: [p, q] per design; requests: [(design, series index)] in
    submission order.  Returns dict(ids [R], weights [per design, after
    the last re-fit], batches, refits (as ``schedule``), fire [R, 3]
    slope-form work of each request's fire, refit_work (up, down, cycles)
    summed over all re-fits, refit_steps: volleys each design folded)."""
    nd = len(designs)
    enc = [tnn.encode(torch.as_tensor(np.asarray(d["series"]), dtype=torch.float32),
                      d["t_max"], "latency").to(device) for d in designs]
    shapes = [(e.shape[1], d["q"], d["t_max"]) for e, d in zip(enc, designs)]
    buckets = envelope_buckets(shapes, waste_cap)
    bucket_of = [0] * nd
    for b, (_, members) in enumerate(buckets):
        for d in members:
            bucket_of[d] = b
    design_of = np.asarray([r[0] for r in requests], np.int64)
    index_of = np.asarray([r[1] for r in requests], np.int64)
    sch = schedule(design_of, bucket_of, len(buckets), batch_size, refit_every,
                   refit_window, refit_epochs)

    # one fold of every design over its re-fit windows laid end to end
    p_env = max(s[0] for s in shapes)
    q_env = max(s[1] for s in shapes)
    window = max(s[2] for s in shapes)
    n_steps = max([len(v) for v in sch["seq"].values()] + [0])
    vol = torch.full((nd, n_steps, p_env), window, dtype=torch.int64, device=device)
    real = torch.zeros((nd, n_steps), dtype=torch.bool, device=device)
    for d in range(nd):
        sq = sch["seq"][d]
        if sq:
            rows = torch.as_tensor(index_of[sq], device=device)
            vol[d, : len(sq), : shapes[d][0]] = enc[d][rows]
            real[d, : len(sq)] = True
    checkpoints: dict = {}
    for d in range(nd):
        for k, pos in enumerate(sch["ends"][d]):
            checkpoints.setdefault(pos, []).append((d, (d, k + 1)))
    w = torch.zeros((nd, p_env, q_env), dtype=dtype, device=device)
    for d in range(nd):
        w[d, : shapes[d][0], : shapes[d][1]] = torch.as_tensor(w0[d]).to(device, dtype)
    start = w.clone()
    ds = tnn.Designs.of([np.float32(d["threshold"]) for d in designs],
                        [d["t_max"] for d in designs], [d["q"] for d in designs],
                        [s[0] for s in shapes], device)
    w, refit_work, refit_steps = tnn.fold(w, vol, ds, rule, 1, window, real=real,
                                          acc=acc, checkpoints=checkpoints)
    saved = checkpoints["saved"]

    # each request fired with its design's weights at its batch
    ids = np.zeros(len(requests), np.int64)
    fire = np.zeros((len(requests), 3), np.int64)
    for d in range(nd):
        p, q, _ = shapes[d]
        mine = np.nonzero(design_of == d)[0]
        if not len(mine):
            continue
        stack = torch.stack([start[d, :p, :q]] + [
            saved[(d, k + 1)][:p, :q] for k in range(len(sch["ends"][d]))])
        grid = torch.round(torch.clamp(stack, 0.0, float(rule.w_max)))
        for c in range(0, len(mine), 2048):
            part = mine[c : c + 2048]
            sub = tnn.Designs.of([np.float32(designs[d]["threshold"])] * len(part),
                                 [designs[d]["t_max"]] * len(part), [q] * len(part),
                                 [p] * len(part), device)
            t, st = tnn.fire_grid(grid[torch.as_tensor(sch["ck"][part], device=device)],
                                  enc[d][torch.as_tensor(index_of[part], device=device)],
                                  sub, window, rule.w_max, acc)
            ids[part] = tnn.ids_from_times(t[:, None, :], sub)[:, 0].cpu().numpy()
            fire[part] = torch.stack([st.up, st.down, st.cycles], 1).cpu().numpy()
    weights = [w[d, : shapes[d][0], : shapes[d][1]] for d in range(nd)]
    return dict(ids=ids, weights=weights, batches=sch["batches"], refits=sch["refits"],
                fire=fire, shapes=shapes, buckets=buckets,
                refit_work=(int(refit_work.up.sum()), int(refit_work.down.sum()),
                            int(refit_work.cycles.sum())),
                refit_steps=[int(v) for v in refit_steps.tolist()])
