"""Time-series -> spike-volley encoders (paper §III-A front end).

Each univariate series of length L feeds a single column with p = L
synapses; each sample's amplitude is converted to a spike *latency* within
the gamma window: larger amplitude -> earlier spike.  An optional
on/off-center pair doubles the synapse count and encodes signed deviations.

Inputs are float32 tensors, as in the JAX package (which runs without
64-bit mode), so both packages round the same values.  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import TIME_DTYPE


ENCODERS = ("latency", "onoff")


def minmax_normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-9) -> torch.Tensor:
    lo = x.amin(dim=axis, keepdim=True)
    hi = x.amax(dim=axis, keepdim=True)
    return (x - lo) / (hi - lo + eps)


def encoded_width(length: int, encoder: str) -> int:
    """Synapse count a series of ``length`` samples encodes to: a design
    with ``p`` synapses accepts exactly the lengths where this equals p."""
    if encoder == "latency":
        return length
    if encoder == "onoff":
        return 2 * length
    raise ValueError(f"unknown encoder: {encoder!r} (have {ENCODERS})")


def encode(x: torch.Tensor, t_max: int, encoder: str = "latency") -> torch.Tensor:
    """Dispatch on the encoder name: [..., L] -> [..., encoded_width(L)]."""
    if encoder == "latency":
        return latency_encode(x, t_max)
    if encoder == "onoff":
        return onoff_encode(x, t_max)
    raise ValueError(f"unknown encoder: {encoder!r} (have {ENCODERS})")


def latency_encode(
    x: torch.Tensor, t_max: int, normalize: bool = True
) -> torch.Tensor:
    """Intensity-to-latency coding: v in [0,1] -> t = round((1-v)*(t_max-1)).

    x: [..., L] real signal -> [..., L] int32 spike times in [0, t_max).
    """
    v = minmax_normalize(x) if normalize else torch.clamp(x, 0.0, 1.0)
    t = torch.round((1.0 - v) * (t_max - 1))
    return torch.clamp(t, 0, t_max - 1).to(TIME_DTYPE)


def onoff_encode(x: torch.Tensor, t_max: int) -> torch.Tensor:
    """On/off-center pair coding: [..., L] -> [..., 2L] spike times.

    The on channel spikes early for positive deviations from the series
    mean, the off channel for negative ones; the silent channel of each
    pair emits no spike (t_max).
    """
    mu = x.mean(dim=-1, keepdim=True)
    dev = x - mu
    mag = minmax_normalize(torch.abs(dev))
    t = torch.round((1.0 - mag) * (t_max - 1)).to(TIME_DTYPE)
    no = torch.full_like(t, t_max)
    on = torch.where(dev >= 0, t, no)
    off = torch.where(dev < 0, t, no)
    return torch.cat([on, off], dim=-1)
