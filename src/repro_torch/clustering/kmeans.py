"""k-means (the paper's normalization baseline for Table II), on the card.

The port's counterpart of the JAX package's ``clustering/kmeans.py``:
the same k-means++ seeding in numpy (so one ``seed`` gives the same
initial centers in both packages), then Lloyd steps in f32 on device
tensors in the reference's form: squared distances summed over the
series axis, first index on ties, per-cluster counts and sums, an empty
cluster keeping its center.  Products run in full f32 (TF32 off).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core import backend as backend_lib


@contextlib.contextmanager
def f32_products():
    """Run CUDA matrix products in full f32 (TF32 off), as the reference
    computes them, and restore the caller's setting afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _plusplus_init(rng: np.random.Generator, x: np.ndarray, k: int) -> np.ndarray:
    """k-means++ seeding (numpy; tiny and sequential by nature)."""
    n = x.shape[0]
    centers = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            ((x[:, None, :] - np.stack(centers)[None]) ** 2).sum(-1), axis=1
        )
        probs = d2 / max(d2.sum(), 1e-12)
        centers.append(x[rng.choice(n, p=probs)])
    return np.stack(centers)


def _assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1)  # [n, k]
    return torch.argmin(d2, dim=1)  # first index on ties


def _lloyd(x: torch.Tensor, centers: torch.Tensor, iters: int):
    """``iters`` Lloyd steps from ``centers``, then one last assignment:
    (centers [k, d], labels [n])."""
    k = centers.shape[0]
    c = centers
    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(_assign(x, c), k).to(x.dtype)
        counts = onehot.sum(0)  # [k]
        sums = onehot.T @ x  # [k, d]
        c = torch.where(
            counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), c
        )
    return c, _assign(x, c)


def kmeans(
    x: np.ndarray, k: int, iters: int = 50, seed: int = 0, restarts: int = 4,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """k-means with k-means++ init and restarts; returns numpy (centers,
    labels) of the restart with the least inertia.  Runs on the card
    unless ``device`` says otherwise."""
    device = backend_lib.default_device(device)
    rng = np.random.default_rng(seed)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    best = None
    with f32_products():
        for _ in range(restarts):
            c0 = _plusplus_init(rng, np.asarray(x, np.float64), k)
            centers, labels = _lloyd(
                xt, torch.as_tensor(c0.astype(np.float32), device=device), iters
            )
            inertia = float(((xt - centers[labels]) ** 2).sum())
            if best is None or inertia < best[0]:
                best = (inertia, centers.cpu().numpy(), labels.cpu().numpy())
    return best[1], best[2]
