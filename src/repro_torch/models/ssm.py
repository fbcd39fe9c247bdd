"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block.

Port of the JAX package's ``models/ssm.py``.  The chunked SSD algorithm:
within a chunk the recurrence is computed in its quadratic "attention"
dual form (batched matrix products), and a cross-chunk state pass stitches
the chunks together.

Block structure (mamba2, conv + gate):
  in_proj -> [z | x | B | C | dt]; short causal depthwise conv on (x, B, C);
  SSD over heads (scalar-identity A per head); y = y * silu(z); RMSNorm;
  out_proj.  n_groups = 1 (B/C shared across heads) for the JAX package's
  configs.  The published Zamba2 (``Zamba2Config``) has ``ssm_groups`` 2
  (head h reads group h // (H / G)'s B and C), a conv bias, softplus(dt)
  clamped below at ``dt_min``, and ``ssm_norm`` 'grouped': norm(y *
  silu(z)) in f32 over groups of d_inner / G, as ``Zamba2RMSNormGated``.

Served with a cache, a prompt runs in chunks of ``ssm_chunk``, the state
carried across them: the no-cache scan with an initial state, the JAX
package's one-chunk prompt in another summation order.  A decode step's
token runs one step of the recurrence (``_one_token``), which the JAX
package computes as a chunk of one token.

Numerics are the JAX package's: a bf16 model runs the dual form's
operands (the decay mask, C B^T and the weighted input) in bf16, their
products accumulated in f32, and the inter-chunk recurrence in f32;
softplus is ``logaddexp(x, 0)``.  A float64 model (the CPU reference of
the card's f32 check) computes all of it in float64.  The plain scan's
decay mask is [B, n_chunks, H, q, q]: at chunk 256 a 4032-token prompt of
zamba2-7b-instruct at batch 8 (H 112) makes it 3.8 GB in f32; on the card
``ssd_chunked`` runs the scan as one kernel that keeps the mask on chip.
The causal conv before it runs on the card as one kernel too
(``_causal_conv``), bit-equal to its plain version, and a decode step's
token (``_one_token``) as two, from the in_proj output to out_proj's input.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.kernels import causal_conv as conv_lib
from repro_torch.kernels import ssd_scan as ssd_lib
from repro_torch.kernels import ssm_step as step_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _acc, _dtype, _is_dtensor, dense_init, rmsnorm

CONV_K = 4  # mamba2 depthwise conv width
# the eps of _gated_norm's 'rmsnorm' form (the JAX package's: its
# rmsnorm's default)
RMSNORM_EPS = 1e-6


def init_ssm_block(generator: torch.Generator, cfg: ArchConfig, *, device=None) -> dict:
    D, Di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    GN = cfg.ssm_groups * cfg.ssm_state
    dt = _dtype(cfg)
    proj_out = 2 * Di + 2 * GN + H
    f32 = dict(dtype=torch.float32, device=device)
    p = {
        "in_proj": dense_init(generator, (D, proj_out), dt, device=device),
        "out_proj": dense_init(generator, (Di, D), dt, device=device),
        "conv_w": dense_init(generator, (CONV_K, Di + 2 * GN), dt, scale=0.5,
                             device=device),
        "A_log": torch.zeros((H,), **f32),  # A = -exp(A_log) = -1 init
        "D_skip": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": torch.ones((Di,), dtype=dt, device=device),
    }
    if cfg.conv_bias:
        p["conv_b"] = torch.zeros((Di + 2 * GN,), dtype=dt, device=device)
    return p


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor, groups: int,
                  eps: float) -> torch.Tensor:
    """Zamba2's gated RMSNorm: y * silu(z) in f32 (float64 for a float64
    model), normalised over ``groups`` groups of the last dim, cast back,
    times ``gamma``."""
    ct = _acc(y.dtype)
    u = y.to(ct) * torch.nn.functional.silu(z.to(ct))
    g = u.reshape(*u.shape[:-1], groups, u.shape[-1] // groups)
    g = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + eps)
    return g.reshape(u.shape).to(y.dtype) * gamma


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width CONV_K, then SiLU.  u: [B, L, C] (any
    strides: the in_proj output's x | B | C columns); w: [K, C]; ``bias``
    [C] added before the SiLU.

    With a ``state`` [B, K-1, C] (a cached prefill), prepends it; else
    zero-pads.  Returns (out [B, L, C], new_state [B, K-1, C]: the last K-1
    rows of concat(state, u)).

    CUDA tensors in bfloat16 or float32 with no gradient required run the
    kernel ``csrc/causal_conv.cu`` (``kernels.causal_conv``, one launch,
    bit-equal); everything else runs ``_causal_conv_plain``: CPU tensors,
    float64, and autograd (the kernel has no backward).
    """
    tensors = [t for t in (u, w, state, bias) if t is not None]
    if (u.device.type == "cuda" and u.dtype in (torch.bfloat16, torch.float32)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))):
        return conv_lib.causal_conv(u, w, state, bias)
    return _causal_conv_plain(u, w, state, bias)


def _causal_conv_plain(u: torch.Tensor, w: torch.Tensor,
                       state: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None):
    """``_causal_conv`` in plain PyTorch (its arguments and result): the
    taps' products summed in f32 (float64 for a float64 model) in tap
    order, the bias, the SiLU, the cast back."""
    Bsz, L, C = u.shape
    if state is None:
        state = u.new_zeros((Bsz, CONV_K - 1, C))
    full = torch.cat([state, u], dim=1)  # [B, K-1+L, C]
    ct = _acc(u.dtype)
    out = torch.zeros((Bsz, L, C), dtype=ct, device=u.device)
    for k in range(CONV_K):
        out = out + full[:, k : k + L, :].to(ct) * w[k].to(ct)[None, None, :]
    if bias is not None:
        out = out + bias.to(ct)
    new_state = full[:, L:, :]
    return torch.nn.functional.silu(out).to(u.dtype), new_state


def ssd_chunked(
    x: torch.Tensor,  # [B, L, H, dh] (dt-unweighted input)
    dt: torch.Tensor,  # [B, L, H] positive step sizes
    A: torch.Tensor,  # [H] negative decay rates
    Bm: torch.Tensor,  # [B, L, N], or [B, L, G, N] for G groups
    Cm: torch.Tensor,  # as Bm
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, N, dh]
    compute_dtype: torch.dtype = torch.float32,
):
    """Chunked SSD scan.  Returns (y [B, L, H, dh], final_state).

    CUDA tensors in bfloat16 or float32 with no gradient required run the
    kernel ``csrc/ssd_scan.cu`` (``kernels.ssd_scan``, one launch, the same
    roundings); everything else runs ``ssd_chunked_plain``: CPU tensors,
    float64, and autograd (the kernel has no backward).
    """
    tensors = (x, dt, A, Bm, Cm) + (() if initial_state is None else (initial_state,))
    if (x.device.type == "cuda" and x.dtype in (torch.bfloat16, torch.float32)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))):
        return ssd_lib.ssd_scan(x, dt, A, Bm, Cm, chunk, initial_state, compute_dtype)
    return ssd_chunked_plain(x, dt, A, Bm, Cm, chunk, initial_state, compute_dtype)


def ssd_chunked_plain(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
):
    """The chunked SSD scan in plain PyTorch (``ssd_chunked``'s arguments
    and result).

    ``compute_dtype=torch.bfloat16`` rounds the dual form's operands to
    bf16 and accumulates their products in f32; the inter-chunk state
    recurrence stays in f32 (float64 for float64 inputs).  With G groups
    of B and C, head h reads group h // (H / G); [B, L, N] is one group.
    """
    Bsz, L, H, dh = x.shape
    if Bm.dim() == 3:
        Bm, Cm = Bm[:, :, None], Cm[:, :, None]
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = H // G
    ct = _acc(x.dtype)
    nc = -(-L // chunk)
    pad = nc * chunk - L
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))

    q = chunk
    xw = (x * dt[..., None]).to(ct)  # dt-weighted input
    dA = (dt * A[None, None, :]).reshape(Bsz, nc, q, H)  # log-decay (negative)
    xw = xw.reshape(Bsz, nc, q, H, dh)
    Bc = Bm.reshape(Bsz, nc, q, G, N).to(ct)
    Cc = Cm.reshape(Bsz, nc, q, G, N).to(ct)
    dA_cs = torch.cumsum(dA, dim=2)  # [B, nc, q, H]

    # --- intra-chunk (quadratic dual form), heads before rows ---
    # Lmask[b,c,h,i,j] = exp(dA_cs_i - dA_cs_j) for j <= i else 0
    cd = compute_dtype
    # contiguous, so the mask is too: a strided mask costs every pass over
    # it a strided copy (3x the device time of the whole block on the card)
    cs = dA_cs.permute(0, 1, 3, 2).contiguous()  # [B, nc, H, q]
    mask = cs[..., :, None] - cs[..., None, :]  # [B, nc, H, q, q]
    upper = ~torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    if mask.requires_grad:  # autograd saves exp's output: no writes into it
        mask = torch.exp(mask).masked_fill(upper, 0.0)
    else:  # in place: serving holds one mask, not three
        mask.exp_()
        mask.masked_fill_(upper, 0.0)
    scores = torch.einsum("bcign,bcjgn->bcgij", Cc.to(cd), Bc.to(cd)).to(ct)
    # the mask rounded to the compute dtype, times its group's scores:
    # products of two cd values, exact in ct
    mask = (mask.to(cd).reshape(Bsz, nc, G, Hg, q, q) * scores[:, :, :, None]
            ).reshape(Bsz, nc, H, q, q)
    xw_cd = xw.to(cd).to(ct).permute(0, 1, 3, 2, 4)  # [B, nc, H, q, dh]
    y_intra = torch.matmul(mask, xw_cd).permute(0, 1, 3, 2, 4)  # [B,nc,q,H,dh]
    del mask

    # --- chunk boundary states ---
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # [B, nc, q, H]
    S_contrib = torch.einsum(
        "bcqgn,bcqgkd->bcgknd", Bc,
        (xw * decay_to_end[..., None]).reshape(Bsz, nc, q, G, Hg, dh),
    ).reshape(Bsz, nc, H, N, dh)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # [B, nc, H]

    S = (initial_state.to(ct) if initial_state is not None
         else torch.zeros((Bsz, H, N, dh), dtype=ct, device=x.device))
    S_prev = []
    for c in range(nc):
        S_prev.append(S)  # state BEFORE this chunk
        S = S * chunk_decay[:, c, :, None, None] + S_contrib[:, c]
    S_prev = torch.stack(S_prev, dim=1)  # [B, nc, H, N, dh]

    # --- inter-chunk contribution ---
    y_inter = torch.einsum(
        "bcqgn,bcgknd->bcqgkd", Cc, S_prev.reshape(Bsz, nc, G, Hg, N, dh),
    ).reshape(Bsz, nc, q, H, dh) * torch.exp(dA_cs)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, nc * q, H, dh)[:, :L]
    return y, S


def ssd_sequential(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
):
    """Step-by-step SSD recurrence oracle (tests validate ssd_chunked):

      S_t = exp(dt_t * A) * S_{t-1} + dt_t * (B_t (x) x_t);   y_t = C_t . S_t

    Bm, Cm: [B, L, N] or [B, L, G, N] (head h reads group h // (H / G)).
    """
    Bsz, L, H, dh = x.shape
    if Bm.dim() == 3:
        Bm, Cm = Bm[:, :, None], Cm[:, :, None]
    G, N = Bm.shape[2], Bm.shape[3]
    ct = _acc(x.dtype)
    Bh = Bm.repeat_interleave(H // G, dim=2)  # [B, L, H, N]
    Ch = Cm.repeat_interleave(H // G, dim=2)
    S = (initial_state.to(ct) if initial_state is not None
         else torch.zeros((Bsz, H, N, dh), dtype=ct, device=x.device))
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t] * A[None, :])  # [B, H]
        S = S * decay[:, :, None, None] + torch.einsum(
            "bhn,bh,bhd->bhnd", Bh[:, t].to(ct), dt[:, t], x[:, t].to(ct))
        ys.append(torch.einsum("bhn,bhnd->bhd", Ch[:, t].to(ct), S))
    return torch.stack(ys, dim=1), S


def ssm_block_apply(
    params: dict,
    h: torch.Tensor,  # [B, L, D]
    cfg: ArchConfig,
    cache: Optional[dict] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """One mamba2 block (pre-norm residual handled by caller).

    cache (decode): {'conv': [B, K-1, Di+2GN], 'S': [B, H, N, dh]}; the new
    states are returned, not written into it.  With a cache, a prompt runs
    in chunks of ``ssm_chunk``, its state carried, and a single token
    (L == 1, a decode step) runs ``_one_token``.
    """
    if _is_dtensor(h):
        return _ssm_block_local(params, h, cfg, cache)
    Di, N, H, dh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    G = cfg.ssm_groups
    Bsz, L, D = h.shape
    ct = _acc(h.dtype)
    proj = h @ params["in_proj"]
    if cache is not None and L == 1:
        return _one_token(params, proj, cfg, cache)
    z, xbc, dt = torch.split(proj, [Di, Di + 2 * G * N, H], dim=-1)

    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(xbc, params["conv_w"], conv_state,
                                      params.get("conv_b"))
    x, Bm, Cm = torch.split(conv_out, [Di, G * N, G * N], dim=-1)
    if G > 1:
        Bm, Cm = Bm.reshape(Bsz, L, G, N), Cm.reshape(Bsz, L, G, N)

    dt = _step_sizes(dt, params, cfg)
    A = -torch.exp(params["A_log"])
    xh = x.reshape(Bsz, L, H, dh)

    # bf16 models run the dual form in bf16 (see ssd_chunked)
    cd = torch.bfloat16 if h.dtype == torch.bfloat16 else ct
    chunk = cfg.ssm_chunk
    if cache is None:
        y, _ = ssd_chunked(xh, dt, A, Bm, Cm, chunk, compute_dtype=cd)
        new_cache = None
    else:
        # a served prompt runs in chunks of ssm_chunk, its state carried
        chunk = min(L, chunk)
        y, S = ssd_chunked(xh, dt, A, Bm, Cm, chunk, initial_state=cache["S"],
                           compute_dtype=cd)
        new_cache = {"conv": new_conv, "S": S}
    obs.count("lm.ssm_chunks", -(-L // chunk))

    y = y + params["D_skip"][None, None, :, None] * xh.to(ct)
    y = _gated_norm(y.reshape(Bsz, L, Di).to(h.dtype), z, params["norm"], cfg)
    return y @ params["out_proj"], new_cache


def _step_sizes(dt: torch.Tensor, params: dict, cfg: ArchConfig) -> torch.Tensor:
    """softplus(dt + dt_bias) in f32 (float64 for a float64 model), clamped
    below at ``cfg.dt_min`` where it is set."""
    dt = dt.to(_acc(dt.dtype)) + params["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros((), dtype=dt.dtype, device=dt.device))
    return torch.clamp(dt, min=cfg.dt_min) if cfg.dt_min else dt


def _gated_norm(y: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """The block's output norm of y gated by z (both in the model's dtype),
    as ``cfg.ssm_norm`` names it."""
    if cfg.ssm_norm == "grouped":
        return gated_rmsnorm(y, z, gamma, cfg.ssm_groups, cfg.norm_eps)
    y = y * torch.nn.functional.silu(z.to(_acc(y.dtype))).to(y.dtype)
    return rmsnorm(y, gamma, RMSNORM_EPS)


def _one_token(params: dict, proj: torch.Tensor, cfg: ArchConfig,
               cache: dict) -> tuple[torch.Tensor, dict]:
    """One token through the block from its in_proj output proj [B, 1, ..]
    and the layer's caches {'conv', 'S'}, which it reads and does not write.
    Returns (y [B, 1, D], the new states), as ``ssm_block_apply``.

    CUDA tensors in bfloat16 or float32 with no gradient required run the
    kernels ``csrc/ssm_step.cu`` (``kernels.ssm_step``, two launches, up to
    out_proj's input: the states bit-equal, y within
    ``repro_torch.testing.ssm_step``'s bound); everything else runs
    ``_one_token_plain``: CPU tensors, float64, and autograd (the kernels
    have no backward).
    """
    keys = ("conv_w", "conv_b", "dt_bias", "A_log", "D_skip", "norm")
    tensors = [proj, cache["conv"], cache["S"]] + [params[k] for k in keys if k in params]
    if not (proj.device.type == "cuda" and proj.dtype in (torch.bfloat16, torch.float32)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))):
        return _one_token_plain(params, proj, cfg, cache)
    grouped = cfg.ssm_norm == "grouped"
    y, conv, S = step_lib.ssm_step(
        proj, cache["conv"], cache["S"], params["conv_w"], params.get("conv_b"),
        params["dt_bias"], params["A_log"], params["D_skip"], params["norm"],
        groups=cfg.ssm_groups, dt_min=cfg.dt_min, norm=cfg.ssm_norm,
        eps=cfg.norm_eps if grouped else RMSNORM_EPS)
    obs.count("lm.ssm_chunks", 1)
    return y @ params["out_proj"], {"conv": conv, "S": S}


def _one_token_plain(params: dict, proj: torch.Tensor, cfg: ArchConfig,
                     cache: dict) -> tuple[torch.Tensor, dict]:
    """``_one_token`` in plain PyTorch (its arguments and result): the conv
    as one product over its window and the SSD as one step of its
    recurrence, S = exp(dt A) S + dt B x^T, y = C . S + D x, in f32
    (float64 for a float64 model) on the model-dtype values; what a chunk
    of one token computes, in fewer launches."""
    Di, N, H, dh, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups
    Bsz, dtype = proj.shape[0], proj.dtype
    ct = _acc(dtype)
    z, xbc, dt = torch.split(proj, [Di, Di + 2 * G * N, H], dim=-1)
    full = torch.cat([cache["conv"], xbc], dim=1)  # [B, K, C]
    conv = (full.to(ct) * params["conv_w"].to(ct)).sum(dim=1)
    if "conv_b" in params:
        conv = conv + params["conv_b"].to(ct)
    x, Bm, Cm = torch.split(torch.nn.functional.silu(conv).to(dtype), [Di, G * N, G * N],
                            dim=-1)
    dt = _step_sizes(dt[:, 0], params, cfg)  # [B, H]
    A = -torch.exp(params["A_log"])
    Hg = H // G
    xh = x.reshape(Bsz, G, Hg, dh).to(ct)
    S = torch.addcmul(
        cache["S"].view(Bsz, G, Hg, N, dh) * torch.exp(dt * A).reshape(Bsz, G, Hg, 1, 1),
        Bm.reshape(Bsz, G, 1, N, 1).to(ct), (xh * dt.reshape(Bsz, G, Hg, 1))[:, :, :, None])
    y = torch.einsum("bgn,bgknd->bgkd", Cm.reshape(Bsz, G, N).to(ct), S)
    obs.count("lm.ssm_chunks", 1)
    y = y + params["D_skip"].reshape(G, Hg, 1) * xh
    y = _gated_norm(y.reshape(Bsz, 1, Di).to(dtype), z, params["norm"], cfg)
    return y @ params["out_proj"], {"conv": full[:, 1:], "S": S.reshape(Bsz, H, N, dh)}


def _ssm_block_local(params: dict, h, cfg: ArchConfig, cache: Optional[dict]):
    """``ssm_block_apply`` on DTensors: each device runs the whole block on
    its own batch rows (a ``local_map``), the block's weights and the
    cache's states gathered whole.  DTensor cannot follow the block's
    split of one sharded projection into five, nor the SSD's merged
    dims, so the block is data-parallel only: its products are not
    tensor-parallel over ``model``, as GSPMD would make them."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = h.device_mesh
    hp = tuple(p if p.is_shard(0) else Replicate() for p in h.placements)
    rep = (Replicate(),) * mesh.ndim
    grad = tuple(Partial() if p.is_shard(0) else Replicate() for p in hp)
    names = sorted(params)
    ws = [params[k] for k in names]
    if cache is None:
        def run(hl, *wl):
            return ssm_block_apply(dict(zip(names, wl)), hl, cfg)[0]

        y = local_map(run, out_placements=list(hp), in_placements=(hp,) + (rep,) * len(ws),
                      in_grad_placements=(hp,) + (grad,) * len(ws), device_mesh=mesh,
                      redistribute_inputs=True)(h, *ws)
        return y, None

    def run_cached(hl, conv, S, *wl):
        y, nc = ssm_block_apply(dict(zip(names, wl)), hl, cfg,
                                cache={"conv": conv, "S": S})
        return y, nc["conv"], nc["S"]

    y, conv, S = local_map(run_cached, out_placements=(list(hp),) * 3,
                           in_placements=(hp, hp, hp) + (rep,) * len(ws),
                           device_mesh=mesh, redistribute_inputs=True)(
        h, cache["conv"], cache["S"], *ws)
    return y, {"conv": conv, "S": S}
