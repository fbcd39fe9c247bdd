"""DTCR-like deep clustering baseline (Ma et al., NeurIPS'19), on the card.

The port's counterpart of the JAX package's ``clustering/dtcr.py``, the
Table II deep baseline: a seq2seq GRU autoencoder whose bottleneck is
regularized by a k-means objective, plus an auxiliary fake-sample
classifier.

  encoder: bidirectional GRU -> final states -> representation h
  decoder: GRU reconstructing the series from zero inputs, state = h
  loss   : reconstruction MSE + lambda * soft k-means loss on h
           + fake-sample discrimination

The same function as the reference, term by term:

* the GRU is the reference's own cell, not ``torch.nn.GRU``: the reset
  gate multiplies the state BEFORE the candidate's product
  (``cat([x, r * h]) @ wh``), where cuDNN's GRU applies it after the
  hidden product, which is another function.  The cell and its scans are
  plain tensor code; gradients come from autograd;
* Adam by hand (b1 0.9, b2 0.999, eps outside the square root), its
  bias correction computed in f32, as the reference does;
* the input is normalized by the population standard deviation;
* the fake samples equal the real ones.  The reference draws the
  positions it overwrites and the positions it copies from with one key,
  one shape and one range, so they coincide and every fake is its own
  series; the port computes the same (``_make_fakes``).

Products run in full f32 (TF32 off).  Initial parameters come from a
``torch.Generator`` (``init_params``) or are carried across from the
JAX package (``params_from_jax``); the initial centers come from numpy,
as in the reference, so one seed gives the same centers in both.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.clustering.kmeans import f32_products, kmeans
from repro_torch.core import backend as backend_lib


@dataclasses.dataclass(frozen=True)
class DTCRConfig:
    hidden: int = 32
    n_clusters: int = 2
    lam_kmeans: float = 0.1
    lam_fake: float = 0.1
    lr: float = 1e-2
    steps: int = 300
    seed: int = 0


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


# ------------------------------------------------------------ parameters
def _tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts of tensors of one shape."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    return [tree]


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _gru_init(generator, in_dim: int, hidden: int, device) -> dict:
    scale = 1.0 / np.sqrt(max(in_dim + hidden, 1))

    def normal(shape):
        return torch.randn(shape, generator=generator) * scale

    w = {k: normal((in_dim + hidden, hidden)) for k in ("wz", "wr", "wh")}
    w.update({k: torch.zeros(hidden) for k in ("bz", "br", "bh")})
    return {k: v.to(device) for k, v in w.items()}


def init_params(generator: torch.Generator, cfg: DTCRConfig, device=None) -> dict:
    """Initial parameters, drawn on the CPU from ``generator`` (the JAX
    package's draws cannot be reproduced; parity runs carry them across
    with ``params_from_jax``)."""
    device = backend_lib.default_device(device)
    h = cfg.hidden
    return {
        "enc_fwd": _gru_init(generator, 1, h, device),
        "enc_bwd": _gru_init(generator, 1, h, device),
        "dec": _gru_init(generator, 1, 2 * h, device),
        "w_out": (torch.randn((2 * h, 1), generator=generator) * 0.1).to(device),
        "b_out": torch.zeros(1, device=device),
        "w_cls": (torch.randn((2 * h, 2), generator=generator) * 0.1).to(device),
        "b_cls": torch.zeros(2, device=device),
    }


def params_from_jax(tree: dict, device=None) -> dict:
    """Carry the JAX package's DTCR parameters across: the same nested
    dict of arrays (numpy, or anything ``np.asarray`` takes) -> f32
    tensors on ``device``."""
    device = backend_lib.default_device(device)
    return _tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(device), tree
    )


def params_to_numpy(params: dict) -> dict:
    """Inverse of ``params_from_jax``."""
    return _tree_map(lambda t: t.detach().cpu().numpy(), params)


# ------------------------------------------------------------------ model
def _gru_cell(params: dict, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    hx = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(hx @ params["wz"] + params["bz"])
    r = torch.sigmoid(hx @ params["wr"] + params["br"])
    hxr = torch.cat([x, r * h], dim=-1)
    hh = torch.tanh(hxr @ params["wh"] + params["bh"])
    return (1 - z) * h + z * hh


def _gru_scan(params: dict, xs: torch.Tensor, h0: torch.Tensor,
              reverse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The cell over xs [L, B, in]: (final state [B, H], states [L, B, H]
    in input order)."""
    h = h0
    hs = [None] * xs.shape[0]
    order = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    for i in order:
        h = _gru_cell(params, h, xs[i])
        hs[i] = h
    return h, torch.stack(hs)


def encode(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, L] -> representation [B, 2H]."""
    xs = x.T[:, :, None]  # [L, B, 1]
    b = x.shape[0]
    h = params["enc_fwd"]["bz"].shape[0]
    h0 = torch.zeros((b, h), dtype=x.dtype, device=x.device)
    hf, _ = _gru_scan(params["enc_fwd"], xs, h0)
    hb, _ = _gru_scan(params["enc_bwd"], xs, h0, reverse=True)
    return torch.cat([hf, hb], dim=-1)


def decode(params: dict, rep: torch.Tensor, length: int) -> torch.Tensor:
    """Teacher-free decoder: zero inputs, state = rep -> [B, L]."""
    xs = torch.zeros((length, rep.shape[0], 1), dtype=rep.dtype, device=rep.device)
    _, hs = _gru_scan(params["dec"], xs, rep)
    return (hs @ params["w_out"] + params["b_out"])[..., 0].T


def _soft_kmeans_loss(rep: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    d2 = ((rep[:, None, :] - centers[None]) ** 2).sum(-1)
    return d2.min(dim=1).values.mean()


def _make_fakes(generator: Optional[torch.Generator], x: torch.Tensor,
                frac: float = 0.2) -> torch.Tensor:
    """DTCR's fake samples, with the reference's semantics: a fraction of
    timesteps overwritten from positions drawn by the same draw as the
    positions written, so every fake equals its series."""
    b, length = x.shape
    n_swap = max(1, int(frac * length))
    idx = torch.randint(0, length, (b, n_swap), generator=generator).to(x.device)
    src = idx  # one key, one shape, one range in the reference
    rows = torch.arange(b, device=x.device)[:, None]
    fakes = x.clone()
    fakes[rows, idx] = x[rows, src]
    return fakes


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Per-series z-score with the population standard deviation."""
    return (x - x.mean(dim=1, keepdim=True)) / (
        x.std(dim=1, keepdim=True, correction=0) + 1e-6
    )


def loss_fn(params: dict, x: torch.Tensor, centers: torch.Tensor,
            cfg: DTCRConfig, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
    """The training loss on normalized series x [B, L]."""
    b, length = x.shape
    rep = encode(params, x)
    recon = decode(params, rep, length)
    l_rec = ((recon - x) ** 2).mean()
    l_km = _soft_kmeans_loss(rep, centers)
    rep_f = encode(params, _make_fakes(generator, x))
    logits = torch.cat([rep, rep_f]) @ params["w_cls"] + params["b_cls"]
    labels = torch.cat([
        torch.zeros(b, dtype=torch.long, device=x.device),
        torch.ones(b, dtype=torch.long, device=x.device),
    ])
    l_fake = -torch.log_softmax(logits, dim=-1)[
        torch.arange(2 * b, device=x.device), labels
    ].mean()
    return l_rec + cfg.lam_kmeans * l_km + cfg.lam_fake * l_fake


def value_and_grad(params: dict, x: torch.Tensor, centers: torch.Tensor,
                   cfg: DTCRConfig, generator: Optional[torch.Generator] = None
                   ) -> tuple[torch.Tensor, dict]:
    """(loss, gradients with the params' tree) by autograd."""
    p = _tree_map(lambda t: t.detach().requires_grad_(True), params)
    with f32_products():
        loss = loss_fn(p, x, centers, cfg, generator)
        grads = torch.autograd.grad(loss, _leaves(p))
    return loss.detach(), _unflatten(params, list(grads))


def adam_step(params: dict, m: dict, v: dict, grads: dict, t: int, lr: float
              ) -> tuple[dict, dict, dict]:
    """One Adam update, the reference's by hand: (params, m, v)."""
    tf = torch.tensor(float(t), dtype=torch.float32)
    c1, c2 = 1 - ADAM_B1 ** tf, 1 - ADAM_B2 ** tf  # f32, as jnp.float32(t)
    m = _tree_map(lambda a, g: ADAM_B1 * a + (1 - ADAM_B1) * g, m, grads)
    v = _tree_map(lambda a, g: ADAM_B2 * a + (1 - ADAM_B2) * g ** 2, v, grads)

    def update(pp, mm, vv):
        mhat = mm / c1.to(mm.device)
        vhat = vv / c2.to(vv.device)
        return pp - lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)

    return _tree_map(update, params, m, v), m, v


def update_centers(params: dict, x: torch.Tensor, centers: torch.Tensor,
                   n_clusters: int) -> torch.Tensor:
    """Hard k-means step of the centers on the current representation."""
    with torch.no_grad(), f32_products():
        rep = encode(params, x)
        d2 = ((rep[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = torch.nn.functional.one_hot(
            torch.argmin(d2, dim=1), n_clusters
        ).to(rep.dtype)
        cnt = assign.sum(0)[:, None]
        return torch.where(
            cnt > 0, (assign.T @ rep) / torch.clamp(cnt, min=1), centers
        )


def initial_centers(cfg: DTCRConfig, device) -> torch.Tensor:
    """Random initial centers from numpy, the reference's draw."""
    c = np.random.default_rng(cfg.seed).normal(size=(cfg.n_clusters, 2 * cfg.hidden))
    return torch.as_tensor(c.astype(np.float32), device=device)


def fit_predict(x: np.ndarray, cfg: DTCRConfig, device=None,
                params: Optional[dict] = None) -> np.ndarray:
    """Train the DTCR-like model and return cluster labels from k-means on
    the learned representation (the DTCR evaluation protocol).  Runs on
    the card unless ``device`` says otherwise; ``params`` (for example
    from ``params_from_jax``) replaces the seeded initial parameters."""
    device = backend_lib.default_device(device)
    xt = normalize(torch.as_tensor(np.asarray(x, np.float32), device=device))
    generator = torch.Generator().manual_seed(cfg.seed)
    if params is None:
        params = init_params(generator, cfg, device)
    params = _tree_map(lambda t: t.detach().to(device), params)
    centers = initial_centers(cfg, device)
    m = _tree_map(torch.zeros_like, params)
    v = _tree_map(torch.zeros_like, params)
    for t in range(1, cfg.steps + 1):
        _, g = value_and_grad(params, xt, centers, cfg, generator)
        with torch.no_grad():
            params, m, v = adam_step(params, m, v, g, t, cfg.lr)
        if t % 10 == 0:
            centers = update_centers(params, xt, centers, cfg.n_clusters)
    with torch.no_grad(), f32_products():
        rep = encode(params, xt).cpu().numpy()
    _, labels = kmeans(rep, cfg.n_clusters, seed=cfg.seed, device=device)
    return labels
