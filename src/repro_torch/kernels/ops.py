"""Public wrappers around the port's kernels.

Which lowering runs is decided by where the tensors are: CUDA tensors
launch the hand-written kernels, CPU tensors take their plain PyTorch
versions (see ``repro_torch.core.backend.lowering``).  The JAX package's
``use_pallas`` flag has no counterpart.

``column_forward`` and ``stdp_step`` are the unfused volley step (RNL
fire + WTA, then the STDP update, one kernel each); ``train_volleys``
folds the same online rule through the fused step, one launch for the
whole batch of volleys.
"""
from __future__ import annotations

import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core.types import ColumnConfig
from repro_torch.kernels import fused_column, ref, rnl_response, stdp_update


def rnl_fire(
    t_in: torch.Tensor,
    w: torch.Tensor,
    threshold: float,
    t_max: int,
    w_max: int,
) -> torch.Tensor:
    """Firing times for integer-weight RNL neurons. [B,p],[p,q] -> [B,q]."""
    return rnl_response.rnl_fire(t_in, w, threshold, t_max, w_max)


def column_forward(
    params: dict, t_in: torch.Tensor, cfg: ColumnConfig
) -> torch.Tensor:
    """Kernel-backed column forward on the integer weight grid: response +
    index tie-break k-WTA.  [B, p] -> [B, q] post-WTA times."""
    w = torch.round(torch.clamp(params["w"], 0.0, float(cfg.neuron.w_max)))
    t_out = rnl_fire(
        t_in, w.contiguous(), cfg.neuron.threshold, cfg.t_max, cfg.neuron.w_max
    )
    return ref.wta_ref(t_out, cfg.wta.k, cfg.t_max)


def stdp_step(
    w: torch.Tensor,
    x_times: torch.Tensor,
    y_times: torch.Tensor,
    cfg: ColumnConfig,
) -> torch.Tensor:
    """Kernel-backed expected-mode STDP update for one volley:
    w [p, q], x [p], y [q] -> new w (``stdp_update.stdp_update``)."""
    s = cfg.stdp
    return stdp_update.stdp_update(
        w, x_times, y_times, s.mu_capture, s.mu_backoff, s.mu_search,
        cfg.neuron.w_max, cfg.t_max, stabilize=s.stabilizer == "half",
    )


def train_volleys(params: dict, x: torch.Tensor, cfg: ColumnConfig) -> dict:
    """Online STDP over a batch of volleys x [B, p] through the fused
    column step: integer-grid fire, expected STDP, index tie-break, one
    epoch.  One launch of the fused-step kernel on the card, its plain
    version on the CPU (``fused_column.fit_fused``)."""
    new_params, _ = fused_column.fit_fused(
        params, x, cfg, epochs=1, lowering=backend_lib.lowering(params["w"]),
        trace=False,
    )
    return new_params
