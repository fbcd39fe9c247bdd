"""Winner-take-all lateral inhibition over a column's output spikes.

Hardware: a priority encoder over the earliest output spike wavefronts
(1-WTA), generalized to k-WTA.  Losers' spikes are inhibited (set to
no-spike); non-spiking neurons can never win.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.types import TIME_DTYPE, WTAConfig


def wta(
    t_out: torch.Tensor,
    cfg: WTAConfig,
    t_max: int,
    generator: Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply k-WTA inhibition.

    Args:
      t_out: [..., q] output spike times (t_max == no spike).
      cfg: WTA configuration.
      t_max: window length.
      generator: a CPU ``torch.Generator``, required iff
        ``cfg.tie_break == 'random'`` (its draws differ from JAX's keys).

    Returns:
      (inhibited [..., q] spike times, winner mask [..., q] bool).
    """
    q = t_out.shape[-1]
    dt = torch.int64 if q * (t_max + 1) > 2**31 else TIME_DTYPE
    t = t_out.to(dt)

    if cfg.tie_break == "index":
        rank = torch.arange(q, dtype=dt, device=t.device).expand(t_out.shape)
    elif cfg.tie_break == "random":
        if generator is None:
            raise ValueError("tie_break='random' requires a torch.Generator")
        # independent random ranks per volley
        u = torch.rand(t_out.shape, generator=generator).to(t.device)
        rank = torch.argsort(torch.argsort(u, dim=-1), dim=-1).to(dt)
    else:  # 'all': ties share the win; rank contributes nothing
        rank = torch.zeros(t_out.shape, dtype=dt, device=t.device)

    # lexicographic (time, rank) packed into one integer key; for 'all' the
    # rank is constant so tied times share the k-th key and all win.
    key = t * q + torch.clamp(rank, max=q - 1)
    kth = torch.sort(key, dim=-1).values[..., cfg.k - 1 : cfg.k]
    win = (key <= kth) & (t_out < t_max)
    inhibited = torch.where(win, t_out, torch.full_like(t_out, t_max))
    return inhibited.to(TIME_DTYPE), win
