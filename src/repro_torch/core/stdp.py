"""Spike-timing-dependent plasticity for TNN columns.

The classic TNN STDP rule (Smith 2020, arXiv:2011.13844).  For synapse
(i, j) with input spike time x_i and post-WTA output spike time y_j
(t_max == none):

  case                         update
  x and y spike, x <= y        w += mu_capture * s_plus(w)    (capture)
  x and y spike, x >  y        w -= mu_backoff * s_minus(w)   (backoff)
  x spikes, y silent           w += mu_search                 (search)
  x silent, y spikes           w -= mu_backoff * s_minus(w)   (backoff)
  neither spikes               no change

With the 'half' stabilizer, s_plus(w) = 1 - w/w_max + eps and
s_minus(w) = w/w_max + eps; 'none' sets both to 1.

Modes: 'expected' applies the float expectation (deterministic);
'stochastic' draws Bernoulli(mu * s) unit-magnitude updates from a
``torch.Generator`` (its bits differ from JAX's threefry keys).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.types import STDPConfig


def _stabilizers(w: torch.Tensor, w_max: int, cfg: STDPConfig):
    if cfg.stabilizer == "none":
        one = torch.ones_like(w)
        return one, one
    frac = torch.clamp(w / w_max, 0.0, 1.0)
    eps = 1.0 / (2 * w_max)
    return (1.0 - frac) + eps, frac + eps


def stdp_delta(
    w: torch.Tensor,
    x_times: torch.Tensor,
    y_times: torch.Tensor,
    cfg: STDPConfig,
    w_max: int,
    t_max: int,
) -> torch.Tensor:
    """Expected STDP update for one volley: w [p, q], x [p], y [q] -> [p, q]."""
    x = x_times[:, None]
    y = y_times[None, :]
    xs = x < t_max
    ys = y < t_max
    s_plus, s_minus = _stabilizers(w, w_max, cfg)

    capture = xs & ys & (x <= y)
    backoff = (xs & ys & (x > y)) | (~xs & ys)
    search = xs & ~ys

    delta = torch.zeros_like(w)
    delta = torch.where(capture, cfg.mu_capture * s_plus, delta)
    delta = torch.where(backoff, -cfg.mu_backoff * s_minus, delta)
    delta = torch.where(search, cfg.mu_search * torch.ones_like(w), delta)
    return delta


def stdp_update(
    w: torch.Tensor,
    x_times: torch.Tensor,
    y_times: torch.Tensor,
    cfg: STDPConfig,
    w_max: int,
    t_max: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Apply one STDP step and clamp to [0, w_max].

    In 'stochastic' mode the magnitudes of ``stdp_delta`` are per-synapse
    Bernoulli probabilities of a +/-1 LSB update (hardware semantics).
    """
    delta = stdp_delta(w, x_times, y_times, cfg, w_max, t_max)
    if cfg.mode == "stochastic":
        if generator is None:
            raise ValueError("stochastic STDP requires a torch.Generator")
        prob = torch.clamp(torch.abs(delta), 0.0, 1.0)
        fire = torch.bernoulli(prob.cpu(), generator=generator).to(w.device)
        delta = torch.sign(delta) * fire.to(w.dtype)
    return torch.clamp(w + delta, 0.0, float(w_max))


def stdp_update_batch(
    w: torch.Tensor,
    x_times: torch.Tensor,
    y_times: torch.Tensor,
    cfg: STDPConfig,
    w_max: int,
    t_max: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sequentially fold a batch of volleys into the weights (online rule).

    x_times: [B, p]; y_times: [B, q].  One gamma window at a time, as the
    hardware does.
    """
    if cfg.mode == "stochastic" and generator is None:
        raise ValueError("stochastic STDP requires a torch.Generator")
    for xt, yt in zip(x_times, y_times):
        w = stdp_update(w, xt, yt, cfg, w_max, t_max, generator=generator)
    return w
