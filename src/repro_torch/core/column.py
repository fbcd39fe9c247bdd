"""Single-column TNN: the paper's NSPU building block.

A column is p synapses x q neurons + WTA inhibition + STDP.  Inference for
one input volley:

  volley [p] --(response fn + threshold)--> spikes [q] --(WTA)--> winners [q]

Training is online: each volley's (input, winner) pair drives one STDP
step.  Weights, the only state, live in a plain dict ``{'w': [p, q]}``.
Execution is dispatched through the backend registry
(``repro_torch.core.backend``): ``mode`` accepts 'auto' | 'event' |
'cycle' | 'pallas', as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import stdp
from repro_torch.core.types import ColumnConfig, TIME_DTYPE, WEIGHT_DTYPE


def init_params(
    cfg: ColumnConfig,
    generator: Optional[torch.Generator] = None,
    device=None,
    w=None,
) -> dict:
    """Weights uniform over [0, w_max] (the hardware reset state randomizes
    the unary counters), drawn on the CPU from ``generator`` and moved to
    ``device``, so one seed gives the same weights on every device.  An
    explicit ``w`` [p, q] is taken as is instead: JAX's generator cannot be
    reproduced in PyTorch, so parity runs carry weights across.
    """
    device = backend_lib.default_device(device)
    if w is None:
        w = torch.rand((cfg.p, cfg.q), generator=generator, dtype=WEIGHT_DTYPE)
        w = w * float(cfg.neuron.w_max)
    w = torch.as_tensor(w, dtype=WEIGHT_DTYPE).to(device)
    if tuple(w.shape) != (cfg.p, cfg.q):
        raise ValueError(f"w must be {(cfg.p, cfg.q)}, got {tuple(w.shape)}")
    return {"w": w.contiguous()}


def params_from_jax(params: dict, device=None) -> dict:
    """Carry the JAX package's column weights across: {'w': array} of
    numpy (or anything ``np.asarray`` takes) -> {'w': f32 tensor}."""
    device = backend_lib.default_device(device)
    w = torch.from_numpy(np.array(params["w"], np.float32))
    return {"w": w.to(device).contiguous()}


def params_to_numpy(params: dict) -> dict:
    """Inverse of ``params_from_jax``: {'w': tensor} -> {'w': np.ndarray}."""
    return {"w": params["w"].detach().cpu().numpy()}


def apply(
    params: dict,
    x_times: torch.Tensor,
    cfg: ColumnConfig,
    mode: str = "auto",
    generator: Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward one or a batch of volleys [..., p].

    Returns (post-WTA spike times [..., q], winner mask [..., q]);
    ``generator`` is only needed for the random WTA tie-break.
    """
    be = backend_lib.get(backend_lib.resolve(mode, cfg))
    return be.fire(params, x_times, cfg, generator=generator)


def train_step(
    params: dict,
    x_times: torch.Tensor,
    cfg: ColumnConfig,
    mode: str = "auto",
    generator: Optional[torch.Generator] = None,
    y_target: Optional[torch.Tensor] = None,
    update: str = "online",
) -> tuple[dict, torch.Tensor]:
    """One training pass over a batch of volleys.

    ``update='online'`` (default) is the hardware's rule: each volley's
    winners come from the weights as updated by every preceding volley.
    ``'batch'`` computes all winners from the stale pre-batch weights,
    then folds the STDP updates in order.  ``y_target`` [..., q]
    overrides the winners as the STDP teacher (supervised mode).

    Returns (new params, winner spike times [..., q]).
    """
    if update == "batch":
        y, _ = apply(params, x_times, cfg, mode, generator)
        teacher = y if y_target is None else y_target
        w = stdp.stdp_update_batch(
            params["w"], x_times.reshape((-1, cfg.p)),
            teacher.reshape((-1, cfg.q)), cfg.stdp, cfg.neuron.w_max,
            cfg.t_max, generator=generator,
        )
        return {"w": w}, y
    if update != "online":
        raise ValueError(f"unknown update: {update!r}")

    batch_shape = x_times.shape[:-1]
    xb = x_times.reshape((-1, cfg.p))
    yt = None if y_target is None else y_target.reshape((-1, cfg.q))
    name = backend_lib.resolve(mode, cfg, training=True)
    new_params, ys = backend_lib.get(name).fit(
        params, xb, cfg, mode, 1, generator, True, yt
    )
    y = ys[0].reshape(batch_shape + (cfg.q,)).to(TIME_DTYPE)
    return new_params, y


def fit(
    params: dict,
    x_times: torch.Tensor,
    cfg: ColumnConfig,
    epochs: int = 8,
    mode: str = "auto",
    generator: Optional[torch.Generator] = None,
) -> dict:
    """Unsupervised online STDP for several passes over the data [N, p]."""
    name = backend_lib.resolve(mode, cfg, training=True)
    new_params, _ = backend_lib.get(name).fit(
        params, x_times, cfg, mode, epochs, generator, False, None
    )
    return new_params


def cluster_assignments(
    params: dict, x_times: torch.Tensor, cfg: ColumnConfig, mode: str = "auto"
) -> torch.Tensor:
    """Winner neuron index per volley = cluster id (paper's clustering use).

    Volleys where no neuron spikes are assigned cluster q (an
    'unclustered' bucket).
    """
    y, win = apply(params, x_times, cfg, mode)
    any_spike = win.any(dim=-1)
    idx = torch.argmin(y, dim=-1)
    return torch.where(any_spike, idx, cfg.q).to(TIME_DTYPE)
