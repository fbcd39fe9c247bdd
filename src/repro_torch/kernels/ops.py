"""Public wrappers around the port's kernels.

Which lowering runs is decided by where the tensors are: CUDA tensors
launch the hand-written kernels, CPU tensors take their plain PyTorch
versions (see ``repro_torch.core.backend.lowering``).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import ColumnConfig
from repro_torch.kernels import ref
from repro_torch.kernels import rnl_response


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
