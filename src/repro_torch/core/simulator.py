"""TNNGen functional simulator front end (paper §II-A), single column.

Ties encoding + column inference + online STDP + clustering metrics into
the "rapid application exploration" loop the paper describes.  The
``mode`` knob selects a backend from the registry
(``repro_torch.core.backend``):

  'auto'   — hybrid: event-driven closed form where exact (RNL/SNL),
             cycle-accurate loop where required (LIF); training routes to
             the fused column step whenever the config fits its contract.
  'event'  — force the closed form.
  'cycle'  — force the cycle-accurate loop.
  'pallas' — force the fused kernel path: the CUDA kernels on the card,
             their plain PyTorch versions on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.clustering.metrics import rand_index as rand_index_fn
from repro_torch.core import backend as backend_lib
from repro_torch.core import column as column_lib
from repro_torch.core import encoding
from repro_torch.core.types import ColumnConfig


@dataclasses.dataclass
class ClusteringResult:
    assignments: np.ndarray  # [N] cluster ids (q == unclustered)
    rand_index: float
    params: dict  # {'w': [p, q] tensor}
    train_seconds: float
    mode: str
    # lowering the fused training path ran on: 'cuda' or 'reference', ''
    # when training resolved to the event/cycle solvers
    lowering: str = ""


def suggest_threshold(cfg: ColumnConfig) -> float:
    """Default firing threshold: a quarter of the expected saturated
    potential p * w_max / 2 of uniform weights, which keeps spike times
    mid-window."""
    return max(1.0, 0.25 * cfg.p * cfg.neuron.w_max / 2.0)


def _encode(x: torch.Tensor, cfg: ColumnConfig, encoder: str) -> torch.Tensor:
    volleys = encoding.encode(x, cfg.t_max, encoder)
    if volleys.shape[-1] != cfg.p:
        raise ValueError(
            f"encoded width {volleys.shape[-1]} != design input width {cfg.p}"
        )
    return volleys


def cluster_time_series(
    series: np.ndarray,
    labels: Optional[np.ndarray],
    cfg: ColumnConfig,
    epochs: int = 8,
    mode: str = "auto",
    seed: int = 0,
    encoder: str = "latency",
    device=None,
    params: Optional[dict] = None,
) -> ClusteringResult:
    """End-to-end: encode -> online STDP -> assign clusters -> rand index.

    Args:
      series: [N, L] real-valued series (L == cfg.p for 'latency', 2L ==
        cfg.p for 'onoff'); encoded in float32, as the JAX package does.
      labels: [N] integer class labels, or None (rand_index = nan).
      cfg: column config (p x q).
      epochs: STDP passes over the data.
      mode: simulation backend, resolved by ``backend.resolve``.
      seed: seeds the one ``torch.Generator`` (weight init, plus the draws
        of stochastic/random configs).  Its weights are not JAX's.
      device: where to run; None means the card (raises without one).
      params: initial weights {'w': [p, q]} (e.g. from
        ``column.params_from_jax``) instead of drawing them.

    ``train_seconds`` covers training and assignment, ended by the copy
    of the assignments to the host.
    """
    device = backend_lib.default_device(device)
    x = torch.as_tensor(np.asarray(series), dtype=torch.float32).to(device)
    volleys = _encode(x, cfg, encoder)
    generator = torch.Generator().manual_seed(seed)
    if params is None:
        params = column_lib.init_params(cfg, generator, device)
    else:
        params = column_lib.init_params(cfg, device=device, w=params["w"])

    t0 = time.perf_counter()
    params = column_lib.fit(
        params, volleys, cfg, epochs=epochs, mode=mode, generator=generator
    )
    assignments = (
        column_lib.cluster_assignments(params, volleys, cfg, mode).cpu().numpy()
    )
    train_seconds = time.perf_counter() - t0

    ri = float("nan")
    if labels is not None:
        ri = float(rand_index_fn(np.asarray(labels), assignments))
    resolved = backend_lib.resolve(mode, cfg, training=True)
    lowering = (
        backend_lib.padded_lowering(cfg.neuron.response, volleys)
        if resolved == "pallas"
        else ""
    )
    return ClusteringResult(assignments, ri, params, train_seconds, mode, lowering)
