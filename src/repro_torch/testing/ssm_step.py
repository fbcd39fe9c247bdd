"""Inputs for the Mamba2 decode step and the bound its kernels
(``kernels.ssm_step``) are held to against the plain version
(``models.ssm._one_token_plain``): shared by the tests and
``chip_smoke.py``.

The kernels make the plain version's roundings, so the new conv state and
the new SSM state S' are compared bit for bit.  y, the gated norm's output
(out_proj's input), is held per element to

    f (SUM_ORDER (N + 2) env + ulp(y)) + MEAN |o| + 3 ulp(o) + FLOOR,

where o is the plain version's output, ulp(v) one unit in the last place
of v in the model's dtype, env = sum_n |C_n S'_n| + |D x| the magnitude of
the terms of y = C . S' + D x before the norm, and f = |silu(z) r gamma|
the factor the norm puts on y (r the plain version's 1 / rms):
* y's N + 1 terms summed in another order differ by at most 2 (N + 2) u
  of env, u = 2^-24 (``SUM_ORDER`` = 2 u);
* y rounded to the dtype can then fall on the other side of a rounding
  boundary: one ulp of y;
* the norm's mean, a sum of positive squares in another order in each
  version (trees and short sequential runs, at most ~64 additions deep),
  differs by at most ``MEAN`` = 2 * 64 u of itself, taken on o;
* o's own roundings after the norm (u r to the dtype, times gamma, and in
  the 'rmsnorm' form u to the dtype first) can each fall the other way:
  three ulps of o;
* an absolute 1e-30 for values at the bottom of f32's range.
"""
from __future__ import annotations

import torch

from repro_torch.models import ssm
from repro_torch.models.config import ArchConfig

U = 2.0 ** -24
SUM_ORDER = 2 * U
MEAN = 2 * 64 * U
FLOOR = 1e-30


def step_inputs(cfg: ArchConfig, b: int, dtype: torch.dtype, device, seed: int = 0):
    """(params, proj, cache) of one mamba layer's decode step at ``cfg``'s
    widths: the block's weights (conv taps and bias, gamma in ``dtype``;
    A_log, D, dt_bias in f32, A = -1..-112 and dt_bias such that
    softplus(dt) spans ~1e-5..3, so ``dt_min`` clamps some heads), an
    in_proj output proj [b, 1, W] and the layer's states (conv in
    ``dtype``, S in f32); out_proj the identity [Di, Di], so that the
    plain version returns out_proj's input exactly."""
    g = torch.Generator().manual_seed(seed)
    H, G, N, dh = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    di = H * dh
    c = di + 2 * G * N
    f32 = torch.float32

    def randn(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=g) * scale).to(dt).to(device)

    params = {
        "conv_w": randn(ssm.CONV_K, c, scale=0.5),
        "A_log": (torch.rand((H,), generator=g) * torch.log(torch.tensor(112.0))).to(device),
        "D_skip": (0.5 + torch.rand((H,), generator=g)).to(device),
        "dt_bias": (torch.rand((H,), generator=g) * 10 - 9).to(device),
        "norm": (0.5 + torch.rand((di,), generator=g)).to(dtype).to(device),
        "out_proj": torch.eye(di, dtype=dtype, device=device),
    }
    if cfg.conv_bias:
        params["conv_b"] = randn(c, scale=0.5)
    proj = randn(b, 1, di + c + H)
    cache = {"conv": randn(b, ssm.CONV_K - 1, c), "S": randn(b, H, N, dh, dt=f32)}
    return params, proj, cache


def _ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One unit in the last place of |v| in ``dtype`` (0 at v = 0)."""
    _, e = torch.frexp(v.abs())
    bits = 8 if dtype == torch.bfloat16 else 24
    return torch.where(v != 0, torch.ldexp(torch.ones_like(v), e - bits),
                       torch.zeros_like(v))


def bound(params: dict, proj: torch.Tensor, cfg: ArchConfig, cache: dict,
          want: tuple) -> torch.Tensor:
    """The per-element bound [b, 1, Di] of y against the plain version's
    result ``want`` = (y, {'conv', 'S'}) on these inputs (module docstring),
    in float64."""
    H, G, N, dh = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    dtype, b, di = proj.dtype, proj.shape[0], H * dh
    f64 = torch.float64
    z, xbc, _ = torch.split(proj[:, 0], [di, di + 2 * G * N, H], dim=-1)
    conv = torch.cat([cache["conv"], xbc[:, None]], dim=1).to(f64)
    conv = (conv * params["conv_w"].to(f64)).sum(dim=1)
    if "conv_b" in params:
        conv = conv + params["conv_b"].to(f64)
    x, _, Cm = torch.split(torch.nn.functional.silu(conv).to(dtype).to(f64),
                           [di, G * N, G * N], dim=-1)
    S = want[1]["S"].to(f64).reshape(b, G, H // G, N, dh)
    Cg = Cm.reshape(b, G, N)
    dx = params["D_skip"].to(f64).repeat_interleave(dh) * x
    env = torch.einsum("bgn,bgknd->bgkd", Cg.abs(), S.abs()).reshape(b, di) + dx.abs()
    y = torch.einsum("bgn,bgknd->bgkd", Cg, S).reshape(b, di) + dx
    gate = torch.nn.functional.silu(z.to(f64))
    if cfg.ssm_norm == "rmsnorm":
        gate = gate.to(dtype).to(f64)
    u = y.to(dtype).to(f64) * gate
    groups = cfg.ssm_groups if cfg.ssm_norm == "grouped" else 1
    eps = cfg.norm_eps if cfg.ssm_norm == "grouped" else ssm.RMSNORM_EPS
    ug = u.reshape(b, groups, di // groups)
    r = torch.rsqrt((ug * ug).mean(dim=-1, keepdim=True) + eps).expand_as(ug).reshape(b, di)
    f = (gate * r * params["norm"].to(f64)).abs()
    o = want[0][:, 0].to(f64)
    out = (f * (SUM_ORDER * (N + 2) * env + _ulp(y, dtype)) + MEAN * o.abs()
           + 3 * _ulp(o, dtype) + FLOOR)
    return out[:, None]


def agreement(got: tuple, want: tuple, params: dict, proj: torch.Tensor,
              cfg: ArchConfig, cache: dict) -> dict:
    """``got`` (the kernel's (y, {'conv', 'S'})) against ``want`` (the plain
    version's): the states bit for bit, y's largest |difference| over the
    bound (<= 1 holds) and its largest |difference|."""
    d = (got[0].double() - want[0].double()).abs()
    b = bound(params, proj, cfg, cache, want)
    return dict(conv_equal=bool(torch.equal(got[1]["conv"], want[1]["conv"])),
                S_equal=bool(torch.equal(got[1]["S"], want[1]["S"])),
                ratio=float((d / b).max()), max_abs=float(d.max()))


def holds(r: dict) -> bool:
    return r["conv_equal"] and r["S_equal"] and r["ratio"] <= 1.0


def twin(params: dict, proj: torch.Tensor, cfg: ArchConfig, cache: dict,
         threads: int = 128) -> tuple:
    """The kernels' arithmetic in PyTorch, on the CPU: the plain version's
    conv step (in the kernels' order, a tap at a time), step sizes and
    state update (``addcmul``, as the plain version), then y = C . S' in the
    kernel's order (a thread sums rows rg, rg + R, ... of its four columns,
    R = ``threads`` / (dh / 4) row groups; then the row groups in order),
    + D x, and the plain version's norm.  Returns what ``_one_token_plain``
    returns, with out_proj applied."""
    H, G, N, dh = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    dtype, b, di, hg = proj.dtype, proj.shape[0], H * dh, H // G
    f32 = torch.float32
    z, xbc, dt = torch.split(proj, [di, di + 2 * G * N, H], dim=-1)
    full = torch.cat([cache["conv"], xbc], dim=1).to(f32)
    acc = torch.zeros_like(full[:, 0])
    for k in range(ssm.CONV_K):
        acc = acc + full[:, k] * params["conv_w"][k].to(f32)
    if "conv_b" in params:
        acc = acc + params["conv_b"].to(f32)
    x, Bm, Cm = torch.split(torch.nn.functional.silu(acc).to(dtype).to(f32),
                            [di, G * N, G * N], dim=-1)
    dt = ssm._step_sizes(dt[:, 0], params, cfg)
    decay = torch.exp(dt * -torch.exp(params["A_log"]))
    xh = x.reshape(b, G, hg, dh)
    xdt = xh * dt.reshape(b, G, hg, 1)
    S = torch.addcmul(cache["S"].view(b, G, hg, N, dh) * decay.reshape(b, G, hg, 1, 1),
                      Bm.reshape(b, G, 1, N, 1), xdt[:, :, :, None])
    rows = threads // (dh // 4)
    Cg = Cm.reshape(b, G, 1, N, 1)
    y = torch.zeros_like(xh)
    for rg in range(rows):
        part = torch.zeros_like(xh)
        for n in range(rg, N, rows):
            part = part + Cg[:, :, :, n] * S[:, :, :, n]
        y = y + part
    y = y + params["D_skip"].reshape(G, hg, 1) * xh
    y = ssm._gated_norm(y.reshape(b, 1, di).to(dtype), z, params["norm"], cfg)
    return y @ params["out_proj"], {"conv": full[:, 1:].to(dtype),
                                    "S": S.reshape(b, H, N, dh)}
