"""Neuron response functions and firing-time solvers.

Semantics (the unary-temporal microarchitecture of Nair et al. ISVLSI'21,
which TNNGen's generated RTL implements):

* An input volley is one spike time per synapse, integer cycles in
  ``[0, t_max)``; ``t >= t_max`` means "no spike".
* RNL (ramp-no-leak): ``r_i(t) = min(relu(t - t_i), w_i)``.
* SNL (step-no-leak): ``r_i(t) = w_i * (t >= t_i)``.
* LIF: impulse input ``w_i`` at ``t_i`` into a leaky accumulator
  ``V(t) = max(V(t-1) - leak, 0) + sum_i w_i * (t_i == t)``.
* Body potential ``V(t) = sum_i r_i(t)`` (RNL/SNL); the neuron emits one
  output spike at the first cycle where ``V(t) >= threshold`` within the
  window, else no spike.

Two solvers, cross-validated in the tests:

* ``fire_times_event``: closed-form event-driven solve.  RNL's V(t) is
  piecewise linear with breakpoints at ``t_i`` and ``t_i + w_i``; the 2p
  slope-change events are sorted (stable), the slope prefix-summed and the
  first threshold crossing solved analytically.  Exact for RNL/SNL.
* ``fire_times_cycle``: a loop over hardware clock cycles, bit-identical to
  the generated RTL (required for LIF).

The JAX package ``vmap``s the one-neuron solvers over neurons and volleys;
here both are batch dimensions written out: events are laid out
``[B, q, 2p]`` and sorted along the last axis.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import NeuronConfig, TIME_DTYPE


def rnl_potential(t, t_in: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Body potential V(t) for RNL neurons.

    t: [...] integer cycle(s); t_in: [p]; w: [p, q] -> [..., q].
    """
    t = torch.as_tensor(t, device=w.device)[..., None, None]
    ramp = torch.minimum(torch.relu(t - t_in[..., None].to(w.dtype)), w)
    return ramp.sum(dim=-2)


def snl_potential(t, t_in: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Body potential V(t) for SNL neurons (step response)."""
    t = torch.as_tensor(t, device=w.device)[..., None, None]
    step = (t >= t_in[..., None]).to(w.dtype) * w
    return step.sum(dim=-2)


def _first_crossing_from_events(
    ev_t: torch.Tensor, ev_ds: torch.Tensor, threshold: float, t_max: int
) -> torch.Tensor:
    """First integer t with V(t) >= threshold from sorted slope events.

    ev_t / ev_ds: [..., e] sorted event times and the slope change at each
    (RNL: +1 at ramp start, -1 at saturation, so V is nondecreasing and
    the first integer crossing is ``ceil`` of the continuous one).
    Returns [...] int32 firing times, t_max if no crossing in-window.

    The two prefix sums run in PyTorch's order, not XLA's; on float
    weights a crossing within an ulp of an integer could round the other
    way (see ROADMAP §3).
    """
    slope = torch.cumsum(ev_ds, dim=-1)
    inf = torch.full_like(ev_t[..., :1], float("inf"))
    t_next = torch.cat([ev_t[..., 1:], inf], dim=-1)
    seg_len = torch.where(
        torch.isfinite(t_next), t_next - ev_t, torch.zeros_like(ev_t)
    )
    # V at each event time: integrate slope over preceding segments.
    v_at_ev = torch.cat(
        [torch.zeros_like(slope[..., :1]),
         torch.cumsum(slope * seg_len, dim=-1)[..., :-1]],
        dim=-1,
    )
    need = threshold - v_at_ev
    dt = torch.where(
        slope > 0, need / torch.clamp(slope, min=1e-30),
        torch.full_like(need, float("inf")),
    )
    dt = torch.clamp(dt, min=0.0)
    t_cross = ev_t + dt
    valid = (t_cross <= t_next) & torch.isfinite(t_cross)
    t_fire = torch.where(valid, t_cross, torch.full_like(t_cross, float("inf")))
    t_fire = t_fire.amin(dim=-1)
    if threshold <= 0:
        t_fire = torch.zeros_like(t_fire)
    t_disc = torch.where(
        torch.isfinite(t_fire), torch.ceil(t_fire),
        torch.full_like(t_fire, float(t_max)),
    )
    return torch.clamp(t_disc, max=float(t_max)).to(TIME_DTYPE)


def _rnl_fire_event_1n(
    t_in: torch.Tensor, w: torch.Tensor, threshold: float, t_max: int
) -> torch.Tensor:
    """Event-driven RNL firing times.  t_in: [B, p]; w: [p, q] -> [B, q].

    Named after the JAX package's one-neuron solver; the neuron and
    volley axes that it ``vmap``s over are explicit here.
    """
    ti = t_in.to(torch.float32)[:, :, None]  # [B, p, 1]
    no = ti >= t_max
    dead = no | (w <= 0)[None]  # [B, p, q]
    start = torch.where(no, float(t_max), ti).expand_as(dead)
    end = torch.where(dead, float(t_max), ti + w[None])
    ev_t = torch.cat([start, end], dim=1).transpose(1, 2)  # [B, q, 2p]
    one = torch.ones_like(end)
    ev_ds = torch.cat(
        [torch.where(dead, 0.0, one), torch.where(dead, 0.0, -one)], dim=1
    ).transpose(1, 2)
    order = torch.argsort(ev_t, dim=-1, stable=True)
    return _first_crossing_from_events(
        torch.gather(ev_t, -1, order), torch.gather(ev_ds, -1, order),
        threshold, t_max,
    )


def _snl_fire_event_1n(
    t_in: torch.Tensor, w: torch.Tensor, threshold: float, t_max: int
) -> torch.Tensor:
    """Event-driven SNL firing times (sorted prefix sum of steps).

    t_in: [B, p]; w: [p, q] -> [B, q].
    """
    no = t_in >= t_max
    times = torch.where(no, torch.full_like(t_in, t_max), t_in)
    order = torch.argsort(times, dim=-1, stable=True)  # [B, p]
    tt = torch.gather(times, -1, order).to(TIME_DTYPE)
    ww = torch.where(no[:, :, None], 0.0, w[None])  # [B, p, q]
    ww = torch.gather(ww, 1, order[:, :, None].expand_as(ww))
    v = torch.cumsum(ww, dim=1)  # [B, p, q]
    hit = v >= threshold
    idx = torch.argmax(hit.to(torch.int8), dim=1)  # first True
    t_first = torch.gather(tt, 1, idx)  # [B, q]
    t_fire = torch.where(hit.any(dim=1), t_first, torch.full_like(t_first, t_max))
    if threshold <= 0:
        t_fire = torch.zeros_like(t_fire)
    return torch.clamp(t_fire, max=t_max).to(TIME_DTYPE)


def fire_times_event(
    t_in: torch.Tensor, w: torch.Tensor, cfg: NeuronConfig, t_max: int
) -> torch.Tensor:
    """Closed-form firing times. t_in: [..., p]; w: [p, q] -> [..., q].

    Exact for 'rnl' and 'snl'; 'lif' has no closed form under leak and
    raises (use ``fire_times_cycle``).
    """
    if cfg.response == "lif":
        raise ValueError("event mode is undefined for LIF; use cycle mode")
    solver = _rnl_fire_event_1n if cfg.response == "rnl" else _snl_fire_event_1n
    batch_shape = t_in.shape[:-1]
    flat = t_in.reshape((-1, t_in.shape[-1]))
    out = solver(flat, w, cfg.threshold, t_max)
    return out.reshape(batch_shape + (w.shape[1],))


def fire_times_cycle(
    t_in: torch.Tensor, w: torch.Tensor, cfg: NeuronConfig, t_max: int
) -> torch.Tensor:
    """Cycle-accurate firing times: a loop over hardware clock cycles.

    Per-cycle response increments accumulate into the body potential; a
    comparator latches the first crossing.  rnl / snl / lif.
    t_in: [..., p]; w: [p, q] -> [..., q].
    """
    batch_shape = t_in.shape[:-1]
    p, q = w.shape
    ti = t_in.reshape((-1, p))
    no = (ti >= t_max)[..., None]  # [B, p, 1]
    tf = ti[..., None].to(torch.float32)
    wf = w[None].to(torch.float32)  # [1, p, q]
    v = torch.zeros((ti.shape[0], q), dtype=torch.float32, device=w.device)
    fired_at = torch.full((ti.shape[0], q), t_max, dtype=TIME_DTYPE, device=w.device)
    for t in range(t_max):
        if cfg.response == "rnl":
            a = torch.clamp(t - tf, min=0.0)
            b = torch.clamp(t - 1 - tf, min=0.0)
            inc = torch.minimum(a, wf) - torch.minimum(b, wf)
            v = v + torch.where(no, 0.0, inc).sum(dim=1)
        else:
            if cfg.response == "lif":
                v = torch.clamp(v - cfg.leak, min=0.0)
            hit = ((ti[..., None] == t) & ~no).expand(-1, -1, q)
            v = v + torch.where(hit, wf, 0.0).sum(dim=1)
        newly = (v >= cfg.threshold) & (fired_at >= t_max)
        fired_at = torch.where(newly, t, fired_at)
    return fired_at.reshape(batch_shape + (q,))


def fire_times(
    t_in: torch.Tensor,
    w: torch.Tensor,
    cfg: NeuronConfig,
    t_max: int,
    mode: str = "auto",
) -> torch.Tensor:
    """Dispatch: 'auto' picks the paper's hybrid strategy (event when exact,
    cycle when required by the response function)."""
    if mode == "auto":
        mode = "cycle" if cfg.response == "lif" else "event"
    if mode == "event":
        return fire_times_event(t_in, w, cfg, t_max)
    if mode == "cycle":
        return fire_times_cycle(t_in, w, cfg, t_max)
    raise ValueError(f"unknown mode: {mode!r}")
