"""Plain PyTorch reference of the TNN column algebra the cells drive.

Written from the paper's semantics (TNNGen §II-A; the RNL column of Nair
et al. ISVLSI'21), with no code of the program: a series is encoded to
one spike time per synapse; a neuron's body potential is
``V(t) = sum_i min(relu(t - x_i), w_i)`` and it fires at the first cycle
with ``V(t) >= threshold`` inside its window, else not at all; k-WTA keeps
the k earliest spikes (lowest index first among ties); expected-mode STDP
updates every synapse of the live neurons from its (input, output) spike
pair.  Training fires on the weights rounded to the hardware's integer
grid; the float-weight assignment fires the weights as they are, with the
potential summed in float64.

Every function takes a batch of independent designs on a leading axis D,
each with its own threshold, window ``t_max`` and live-neuron count.
Designs narrower than the batch are padded with silent synapses (time >=
t_max) and masked neurons (index >= q_active), volleys with silent ones
(every time >= t_max): for thresholds above zero these are exact no-ops.
``dtype`` and ``acc`` set the precision of the weights and of the
potential: float32 (float64 for the float-weight assignment) is the
configuration's; the control computes both in bfloat16.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Designs:
    """Per-design scalars of a batch: threshold [D] f32, t_max [D],
    live neurons [D], true synapse count [D] (int64), all on one device."""

    thr: torch.Tensor
    tm: torch.Tensor
    qa: torch.Tensor
    p: torch.Tensor

    @classmethod
    def of(cls, thr, tm, qa, p, device) -> "Designs":
        return cls(
            torch.as_tensor(np.asarray(thr, np.float32), device=device),
            torch.as_tensor(np.asarray(tm, np.int64), device=device),
            torch.as_tensor(np.asarray(qa, np.int64), device=device),
            torch.as_tensor(np.asarray(p, np.int64), device=device),
        )

    def take(self, idx: torch.Tensor) -> "Designs":
        return Designs(self.thr[idx], self.tm[idx], self.qa[idx], self.p[idx])


@dataclasses.dataclass
class FireStats:
    """Slope-form work of a set of fires, per design [D] int64: synapses
    whose ramp starts inside the window (``up``), those that also top out
    inside it (``down``), and live-neuron cycles scanned up to and
    including each crossing (``cycles``; t_max for a neuron that never
    fires)."""

    up: torch.Tensor
    down: torch.Tensor
    cycles: torch.Tensor

    @classmethod
    def zeros(cls, d: int, device) -> "FireStats":
        z = lambda: torch.zeros(d, dtype=torch.int64, device=device)  # noqa: E731
        return cls(z(), z(), z())

    def add(self, other: "FireStats", mask: Optional[torch.Tensor] = None) -> None:
        for f in ("up", "down", "cycles"):
            v = getattr(other, f)
            setattr(self, f, getattr(self, f) + (v if mask is None else v * mask))


# ------------------------------------------------------------ encoders
def minmax(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    return (x - lo) / (hi - lo + 1e-9)


def encode(x: torch.Tensor, t_max: int, encoder: str) -> torch.Tensor:
    """[N, L] float32 series -> [N, p] int64 spike times.  Latency: the
    min-max normalised amplitude v spikes at round((1 - v)(t_max - 1)).
    On/off: a pair of channels per sample, the on channel for deviations
    at or above the series mean, the off channel for those below, each at
    the latency of the normalised magnitude; the other channel is silent
    (t_max)."""
    x = x.to(torch.float32)
    if encoder == "latency":
        t = torch.round((1.0 - minmax(x)) * (t_max - 1))
        return torch.clamp(t, 0, t_max - 1).to(torch.int64)
    if encoder == "onoff":
        dev = x - x.mean(dim=-1, keepdim=True)
        t = torch.round((1.0 - minmax(torch.abs(dev))) * (t_max - 1)).to(torch.int64)
        silent = torch.full_like(t, t_max)
        return torch.cat([torch.where(dev >= 0, t, silent),
                          torch.where(dev < 0, t, silent)], dim=-1)
    raise ValueError(f"unknown encoder {encoder!r}")


# ----------------------------------------------------------------- fire
def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Running sum along the last axis in x's own precision: one rounded
    addition a step below float32 (PyTorch's own cumsum of a bfloat16
    tensor adds in float32 and rounds only what it stores)."""
    if x.dtype in (torch.float32, torch.float64):
        return torch.cumsum(x, dim=-1)
    out = x.clone()
    for k in range(1, x.shape[-1]):
        out[..., k] = out[..., k - 1] + x[..., k]
    return out


def _live_q(q: int, ds: Designs) -> torch.Tensor:
    return torch.arange(q, device=ds.qa.device)[None, :] < ds.qa[:, None]


def fire_grid(g: torch.Tensor, x: torch.Tensor, ds: Designs, window: int,
              w_max: int, acc: torch.dtype = torch.float32) -> tuple[torch.Tensor, FireStats]:
    """Firing times on integer weights.  g [D, p, q] (integer values in
    [0, w_max]), x [D, p] int64 -> ([D, q] int64, work).

    min(relu(t - x), g) counts the cycles s < t with x <= s < x + g, so
    V(t) is the running sum of a slope that rises by one at each live
    input's spike time and falls by one g cycles later: a histogram of
    those edges, summed twice, gives V at every cycle of the window."""
    d, p, q = g.shape
    dev = g.device
    gi = g.to(torch.int64)
    tm = ds.tm[:, None]
    live = x < tm                                              # [D, p]
    bins = window + int(w_max) + 2
    dump = bins - 1
    rise = torch.zeros((d, bins), dtype=acc, device=dev)
    rise.scatter_add_(1, torch.where(live, x, dump), live.to(acc))
    top = torch.where(live[:, :, None], x[:, :, None] + gi, dump)  # [D, p, q]
    fall = torch.zeros((d, q, bins), dtype=acc, device=dev)
    fall.scatter_add_(2, top.transpose(1, 2),
                      live.to(acc)[:, None, :].expand(d, q, p))
    slope = _cumsum(rise[:, None, :] - fall)
    v_incl = _cumsum(slope)[..., : window - 1]
    v = torch.cat([torch.zeros_like(v_incl[..., :1]), v_incl], dim=-1)  # [D, q, T]
    tv = torch.arange(window, device=dev)
    below = (v < ds.thr[:, None, None].to(v.dtype)) & (tv < tm[:, :, None])
    t = torch.minimum(below.sum(dim=-1), tm)
    lq = _live_q(q, ds)
    t = torch.where(lq, t, tm)
    # slope-form work: edges of live synapses onto live neurons
    edge = live[:, :, None] & (gi > 0) & lq[:, None, :]
    ends = edge & (x[:, :, None] + gi < tm[:, :, None])
    cycles = (torch.minimum(t + 1, tm) * lq).sum(dim=-1)
    return t, FireStats(edge.sum(dim=(1, 2)), ends.sum(dim=(1, 2)), cycles)


def fire_dense(w: torch.Tensor, x: torch.Tensor, ds: Designs, window: int,
               acc: torch.dtype = torch.float64,
               chunk_elems: int = 1 << 26) -> tuple[torch.Tensor, FireStats]:
    """Firing times on weights as they are, by the potential's definition
    at every cycle.  w [D, p, q], x [D, N, p] int64 -> ([D, N, q] int64,
    work of the same fire in the slope form, with a ramp's top at x + w)."""
    d, n, p = x.shape
    q = w.shape[2]
    dev = w.device
    tv = torch.arange(window, device=dev, dtype=torch.float32)
    tm = ds.tm[:, None, None]
    lq = _live_q(q, ds)
    per = max(1, chunk_elems // max(1, d * p * q * window))
    out = []
    stats = FireStats.zeros(d, dev)
    for c in range(0, n, per):
        xc = x[:, c : c + per]                                  # [D, n, p]
        live = xc < tm
        a = torch.relu(tv - xc[..., None].to(torch.float32))
        a = torch.where(live[..., None], a, 0.0).to(w.dtype)   # [D, n, p, T]
        v = torch.minimum(a[:, :, :, None, :], w[:, None, :, :, None]).sum(
            dim=2, dtype=acc)                                   # [D, n, q, T]
        below = (v < ds.thr[:, None, None, None].to(acc)) & (tv < tm[..., None])
        t = torch.minimum(below.sum(dim=-1), tm)
        t = torch.where(lq[:, None, :], t, tm)
        out.append(t)
        edge = live[..., None] & (w[:, None] > 0) & lq[:, None, None, :]
        ends = edge & (xc[..., None].to(torch.float32) + w[:, None].float()
                       < tm[..., None].float())
        stats.up += edge.sum(dim=(1, 2, 3))
        stats.down += ends.sum(dim=(1, 2, 3))
        stats.cycles += (torch.minimum(t + 1, tm) * lq[:, None, :]).sum(dim=(1, 2))
    return torch.cat(out, dim=1), stats


def wta(t: torch.Tensor, tm: torch.Tensor, k: int) -> torch.Tensor:
    """k-WTA with the lowest index first among ties: [..., q] firing
    times -> winners' times, everyone else at t_max.  ``tm`` broadcasts
    against [..., 1]."""
    q = t.shape[-1]
    key = t * q + torch.arange(q, device=t.device)
    kth = torch.sort(key, dim=-1).values[..., k - 1 : k]
    win = (key <= kth) & (t < tm)
    return torch.where(win, t, tm)


def ids_from_times(t: torch.Tensor, ds: Designs) -> torch.Tensor:
    """Cluster id per volley: the earliest-firing neuron (lowest index
    among ties), or q_active when none fires.  t [D, N, q] -> [D, N]."""
    spiked = (t < ds.tm[:, None, None]).any(dim=-1)
    return torch.where(spiked, torch.argmin(t, dim=-1), ds.qa[:, None])


# ----------------------------------------------------------------- STDP
@dataclasses.dataclass(frozen=True)
class Rule:
    """Expected-mode STDP: capture (both spike, input first or together)
    adds mu_capture * B+, backoff (both spike, input later; or only the
    output spikes) subtracts mu_backoff * B-, search (only the input
    spikes) adds mu_search.  With the stabiliser B+ = 1 + eps - w/w_max
    and B- = w/w_max + eps, eps = 1/(2 w_max), in float32 (w/w_max as w
    times the float32 reciprocal); without it both are 1."""

    mu_capture: float
    mu_backoff: float
    mu_search: float
    stabilize: bool
    w_max: int = 7
    wta_k: int = 1


def stdp(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, tm: torch.Tensor,
         rule: Rule) -> torch.Tensor:
    """w [D, p, q], input times x [D, p], winner times y [D, q], t_max
    [D] -> updated weights clamped to [0, w_max], in w's dtype."""
    tmf = tm.to(torch.float32)[:, None, None]
    xf = x.to(torch.float32)[:, :, None]
    yf = y.to(torch.float32)[:, None, :]
    xs, ys = xf < tmf, yf < tmf
    if rule.stabilize:
        eps = 1.0 / (2 * rule.w_max)
        inv = float(np.float32(1.0) / np.float32(rule.w_max))
        frac = torch.clamp(w * inv, 0.0, 1.0)
        s_plus = float(np.float32(1.0) + np.float32(eps)) - frac
        s_minus = frac + float(np.float32(eps))
    else:
        s_plus = s_minus = torch.ones_like(w)
    capture = xs & ys & (xf <= yf)
    backoff = (xs & ys & (xf > yf)) | (~xs & ys)
    search = xs & ~ys
    delta = torch.zeros_like(w)
    delta = torch.where(capture, rule.mu_capture * s_plus, delta)
    delta = torch.where(backoff, -rule.mu_backoff * s_minus, delta)
    delta = torch.where(search, rule.mu_search * torch.ones_like(w), delta)
    return torch.clamp(w + delta, 0.0, float(rule.w_max))


def fold(w: torch.Tensor, volleys: torch.Tensor, ds: Designs, rule: Rule,
         epochs: int, window: int, real: Optional[torch.Tensor] = None,
         acc: torch.dtype = torch.float32, rows: Optional[torch.Tensor] = None,
         checkpoints: Optional[dict] = None) -> tuple[torch.Tensor, FireStats, torch.Tensor]:
    """Online STDP: each volley fires on the integer grid of the weights
    the previous volleys left, k-WTA picks the winners, STDP updates.

    w [D, p, q]; volleys [D, S, p] int64 in order (or [R, S, p] with
    ``rows`` [D] naming each design's row); ``real`` [D, S] bool
    marks each design's own volleys (the rest pad shorter streams and are
    no-ops) for the work count.  ``checkpoints`` {steps done: [(design,
    key)]} collects copies of a design's weights after that many volleys
    under ``key``.  Returns (weights, fire work, real volleys folded [D])."""
    d, q = w.shape[0], w.shape[2]
    s = volleys.shape[1]
    lq = _live_q(q, ds)[:, None, :]
    stats = FireStats.zeros(d, w.device)
    n_real = torch.zeros(d, dtype=torch.int64, device=w.device)
    if real is None:
        real = torch.ones((d, s), dtype=torch.bool, device=w.device)
    saved = {}
    for e in range(epochs):
        for i in range(s):
            step = e * s + i
            if checkpoints and step in checkpoints:
                for dd, key in checkpoints[step]:
                    saved[key] = w[dd].clone()
            x = volleys[:, i] if rows is None else volleys[rows, i]
            g = torch.round(torch.clamp(w, 0.0, float(rule.w_max)))
            t, st = fire_grid(g, x, ds, window, rule.w_max, acc)
            y = wta(t, ds.tm[:, None], rule.wta_k)
            w = torch.where(lq, stdp(w, x, y, ds.tm, rule), w)
            m = real[:, i].to(torch.int64)
            stats.add(st, m)
            n_real += m
    if checkpoints and epochs * s in checkpoints:
        for dd, key in checkpoints[epochs * s]:
            saved[key] = w[dd].clone()
    if checkpoints is not None:
        checkpoints["saved"] = saved
    return w, stats, n_real


# ----------------------------------------------------------- the scores
def rand_index(labels: np.ndarray, ids: np.ndarray) -> float:
    """Unadjusted Rand index from the contingency table: agreeing pairs
    (same class and cluster, or different in both) over all pairs."""
    a = np.asarray(labels).ravel()
    b = np.asarray(ids).ravel()
    n = a.size
    if n < 2:
        return 1.0
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    cont = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(cont, (ai, bi), 1)
    same = (cont * (cont - 1) // 2).sum()
    rows = (cont.sum(1) * (cont.sum(1) - 1) // 2).sum()
    cols = (cont.sum(0) * (cont.sum(0) - 1) // 2).sum()
    total = n * (n - 1) // 2
    return float((same + (total - rows - cols + same)) / total)


def suggest_threshold(p: int, w_max: int) -> float:
    """The operating point a design's threshold is set from: a quarter of
    the saturated potential p * w_max / 2 of uniform weights (at least 1)."""
    return max(1.0, 0.25 * p * w_max / 2.0)


def dse_initial_weights(seed: int, index: int, p: int, q: int, w_max: int) -> torch.Tensor:
    """A candidate's initial weights as the exploration documents them:
    uniform over [0, w_max] in float32, from a CPU ``torch.Generator``
    seeded by the first 8 bytes (little endian, halved) of
    sha256("<seed>/<candidate index>")."""
    h = hashlib.sha256(f"{int(seed)}/{int(index)}".encode()).digest()
    gen = torch.Generator().manual_seed(int.from_bytes(h[:8], "little") >> 1)
    return torch.rand((p, q), generator=gen, dtype=torch.float32) * float(w_max)
