"""Plain PyTorch oracles, the counterparts of the JAX package's
``kernels/ref.py``.

These are the semantic ground truth: spike times are integers, so
comparisons are equality; the STDP update is float.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import TIME_DTYPE


def rnl_fire_ref(
    t_in: torch.Tensor, w: torch.Tensor, threshold: float, t_max: int
) -> torch.Tensor:
    """Reference RNL firing times via dense time evaluation.

    V[b, j, t] = sum_i min(relu(t - t_in[b, i]), w[i, j]); the firing time
    is the first integer t with V >= threshold (t_max if none), which,
    V being nondecreasing, is the count of sub-threshold cycles.
    t_in: [B, p]; w: [p, q] -> [B, q] int32.
    """
    t = torch.arange(t_max, dtype=torch.float32, device=w.device)
    a = torch.relu(t[None, None, :] - t_in[:, :, None].to(torch.float32))
    ramp = torch.minimum(a[:, :, None, :], w[None, :, :, None])  # [B, p, q, T]
    v = ramp.sum(dim=1)  # [B, q, T]
    return (v < threshold).sum(dim=-1).to(TIME_DTYPE)


def rnl_fire_ref_planes(
    t_in: torch.Tensor, w: torch.Tensor, threshold: float, t_max: int, w_max: int
) -> torch.Tensor:
    """Oracle of the one-hot weight-plane decomposition (integer weights).

    min(relu(d), w) = relu(d) - sum_v 1[w == v] * relu(d - v) for w in
    {0..w_max}: the algebra the TPU kernel put on its matrix unit.
    """
    t = torch.arange(t_max, dtype=torch.float32, device=w.device)
    a = torch.relu(t[None, None, :] - t_in[:, :, None].to(torch.float32))
    base = a.sum(dim=1)  # [B, T]
    wi = torch.round(w).to(torch.int32)
    acc = torch.zeros((t_in.shape[0], w.shape[1], t_max), dtype=torch.float32,
                      device=w.device)
    for v in range(w_max + 1):
        plane = (wi == v).to(torch.float32)  # [p, q]
        acc = acc + torch.einsum("pq,bpt->bqt", plane, torch.relu(a - v))
    vbt = base[:, None, :] - acc
    return (vbt < threshold).sum(dim=-1).to(TIME_DTYPE)


def wta_ref(t_out: torch.Tensor, k: int, t_max: int) -> torch.Tensor:
    """Index tie-break k-WTA reference: [B, q] -> [B, q] inhibited times."""
    q = t_out.shape[-1]
    key = t_out.to(torch.int32) * q + torch.arange(q, dtype=torch.int32,
                                                   device=t_out.device)
    kth = torch.sort(key, dim=-1).values[..., k - 1 : k]
    win = (key <= kth) & (t_out < t_max)
    return torch.where(win, t_out, torch.full_like(t_out, t_max)).to(TIME_DTYPE)


def stdp_ref(
    w: torch.Tensor,
    x_times: torch.Tensor,
    y_times: torch.Tensor,
    mu_capture,
    mu_backoff,
    mu_search,
    w_max: int,
    t_max,
    stabilize: bool = True,
) -> torch.Tensor:
    """Expected-mode STDP update oracle for one volley.

    w: [..., p, q]; x_times: [..., p]; y_times: [..., q]; the mus and
    ``t_max`` are Python numbers or tensors broadcast against ``[..., 1, 1]``.
    The stabilizer divides by ``w_max``, as the JAX package's reference
    lowering does (its TPU kernel multiplied by the reciprocal, which can
    differ by an ulp).
    """
    x = x_times[..., :, None]
    y = y_times[..., None, :]
    xs = x < t_max
    ys = y < t_max
    if stabilize:
        frac = torch.clamp(w / w_max, 0.0, 1.0)
        eps = 1.0 / (2 * w_max)
        s_plus, s_minus = (1.0 - frac) + eps, frac + eps
    else:
        s_plus = s_minus = torch.ones_like(w)
    capture = xs & ys & (x <= y)
    backoff = (xs & ys & (x > y)) | (~xs & ys)
    search = xs & ~ys
    delta = torch.zeros_like(w)
    delta = torch.where(capture, mu_capture * s_plus, delta)
    delta = torch.where(backoff, -mu_backoff * s_minus, delta)
    delta = torch.where(search, mu_search * torch.ones_like(w), delta)
    return torch.clamp(w + delta, 0.0, float(w_max))
