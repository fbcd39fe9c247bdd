"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block.

Port of the JAX package's ``models/ssm.py``.  The chunked SSD algorithm:
within a chunk the recurrence is computed in its quadratic "attention"
dual form (batched matrix products), and a cross-chunk state pass stitches
the chunks together.  Served with a cache, a prompt runs as one chunk and
a decode step as a chunk of one token, as in the JAX package.

Block structure (mamba2, conv + gate):
  in_proj -> [z | x | B | C | dt]; short causal depthwise conv on (x, B, C);
  SSD over heads (scalar-identity A per head); y = y * silu(z); RMSNorm;
  out_proj.  n_groups = 1 (B/C shared across heads).

Numerics are the JAX package's: a bf16 model runs the dual form's
operands (the decay mask, C B^T and the weighted input) in bf16, their
products accumulated in f32, and the inter-chunk recurrence in f32;
softplus is ``logaddexp(x, 0)``.  A float64 model (the CPU reference of
the card's f32 check) computes all of it in float64.  The decay mask of
one chunk is [B, n_chunks, H, q, q]: a 2048-token prompt of zamba2-7b at
batch 4 (H 112) makes it 7.5 GB in f32 on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _acc, _dtype, dense_init, rmsnorm

CONV_K = 4  # mamba2 depthwise conv width


def init_ssm_block(generator: torch.Generator, cfg: ArchConfig, *, device=None) -> dict:
    D, Di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = _dtype(cfg)
    proj_out = 2 * Di + 2 * N + H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(generator, (D, proj_out), dt, device=device),
        "out_proj": dense_init(generator, (Di, D), dt, device=device),
        "conv_w": dense_init(generator, (CONV_K, Di + 2 * N), dt, scale=0.5,
                             device=device),
        "A_log": torch.zeros((H,), **f32),  # A = -exp(A_log) = -1 init
        "D_skip": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": torch.ones((Di,), dtype=dt, device=device),
    }


def _split_proj(p: torch.Tensor, cfg: ArchConfig):
    Di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(p, [Di, Di, N, N, H], dim=-1)  # z, x, B, C, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width CONV_K.  u: [B, L, C]; w: [K, C].

    With a ``state`` [B, K-1, C] (decode), prepends it; else zero-pads.
    Returns (out [B, L, C], new_state [B, K-1, C]).
    """
    Bsz, L, C = u.shape
    if state is None:
        state = u.new_zeros((Bsz, CONV_K - 1, C))
    full = torch.cat([state, u], dim=1)  # [B, K-1+L, C]
    ct = _acc(u.dtype)
    out = torch.zeros((Bsz, L, C), dtype=ct, device=u.device)
    for k in range(CONV_K):
        out = out + full[:, k : k + L, :].to(ct) * w[k].to(ct)[None, None, :]
    new_state = full[:, L:, :]
    return torch.nn.functional.silu(out).to(u.dtype), new_state


def ssd_chunked(
    x: torch.Tensor,  # [B, L, H, dh] (dt-unweighted input)
    dt: torch.Tensor,  # [B, L, H] positive step sizes
    A: torch.Tensor,  # [H] negative decay rates
    Bm: torch.Tensor,  # [B, L, N]
    Cm: torch.Tensor,  # [B, L, N]
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, N, dh]
    compute_dtype: torch.dtype = torch.float32,
):
    """Chunked SSD scan.  Returns (y [B, L, H, dh], final_state).

    ``compute_dtype=torch.bfloat16`` rounds the dual form's operands to
    bf16 and accumulates their products in f32; the inter-chunk state
    recurrence stays in f32 (float64 for float64 inputs).
    """
    Bsz, L, H, dh = x.shape
    N = Bm.shape[-1]
    ct = _acc(x.dtype)
    nc = -(-L // chunk)
    pad = nc * chunk - L
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))

    q = chunk
    xw = (x * dt[..., None]).to(ct)  # dt-weighted input
    dA = (dt * A[None, None, :]).reshape(Bsz, nc, q, H)  # log-decay (negative)
    xw = xw.reshape(Bsz, nc, q, H, dh)
    Bc = Bm.reshape(Bsz, nc, q, N).to(ct)
    Cc = Cm.reshape(Bsz, nc, q, N).to(ct)
    dA_cs = torch.cumsum(dA, dim=2)  # [B, nc, q, H]

    # --- intra-chunk (quadratic dual form), heads before rows ---
    # Lmask[b,c,h,i,j] = exp(dA_cs_i - dA_cs_j) for j <= i else 0
    cd = compute_dtype
    # contiguous, so the mask is too: a strided mask costs every pass over
    # it a strided copy (3x the device time of the whole block on the card)
    cs = dA_cs.permute(0, 1, 3, 2).contiguous()  # [B, nc, H, q]
    mask = cs[..., :, None] - cs[..., None, :]  # [B, nc, H, q, q]
    mask.exp_()
    mask.masked_fill_(~torch.ones((q, q), dtype=torch.bool, device=x.device).tril(), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", Cc.to(cd), Bc.to(cd)).to(ct)
    # the mask rounded to the compute dtype, times the scores: products of
    # two cd values, exact in ct
    mask = mask.to(cd) * scores[:, :, None]
    xw_cd = xw.to(cd).to(ct).permute(0, 1, 3, 2, 4)  # [B, nc, H, q, dh]
    y_intra = torch.matmul(mask, xw_cd).permute(0, 1, 3, 2, 4)  # [B,nc,q,H,dh]
    del mask

    # --- chunk boundary states ---
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # [B, nc, q, H]
    S_contrib = torch.einsum("bcqn,bcqhd->bchnd", Bc, xw * decay_to_end[..., None])
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # [B, nc, H]

    S = (initial_state.to(ct) if initial_state is not None
         else torch.zeros((Bsz, H, N, dh), dtype=ct, device=x.device))
    S_prev = []
    for c in range(nc):
        S_prev.append(S)  # state BEFORE this chunk
        S = S * chunk_decay[:, c, :, None, None] + S_contrib[:, c]
    S_prev = torch.stack(S_prev, dim=1)  # [B, nc, H, N, dh]

    # --- inter-chunk contribution ---
    y_inter = torch.einsum("bcqn,bchnd->bcqhd", Cc, S_prev) * torch.exp(dA_cs)[..., None]
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
    """
    Bsz, L, H, dh = x.shape
    N = Bm.shape[-1]
    ct = _acc(x.dtype)
    S = (initial_state.to(ct) if initial_state is not None
         else torch.zeros((Bsz, H, N, dh), dtype=ct, device=x.device))
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t] * A[None, :])  # [B, H]
        S = S * decay[:, :, None, None] + torch.einsum(
            "bn,bh,bhd->bhnd", Bm[:, t].to(ct), dt[:, t], x[:, t].to(ct))
        ys.append(torch.einsum("bn,bhnd->bhd", Cm[:, t].to(ct), S))
    return torch.stack(ys, dim=1), S


def ssm_block_apply(
    params: dict,
    h: torch.Tensor,  # [B, L, D]
    cfg: ArchConfig,
    cache: Optional[dict] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """One mamba2 block (pre-norm residual handled by caller).

    cache (decode): {'conv': [B, K-1, Di+2N], 'S': [B, H, N, dh]}; the new
    states are returned, not written into it.
    """
    Di, N, H, dh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Bsz, L, D = h.shape
    ct = _acc(h.dtype)
    proj = h @ params["in_proj"]
    z, x, Bm, Cm, dt = _split_proj(proj, cfg)

    conv_in = torch.cat([x, Bm, Cm], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"], conv_state)
    x, Bm, Cm = torch.split(conv_out, [Di, N, N], dim=-1)

    dt = dt.to(ct) + params["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros((), dtype=dt.dtype, device=dt.device))
    A = -torch.exp(params["A_log"])
    xh = x.reshape(Bsz, L, H, dh)

    # bf16 models run the dual form in bf16 (see ssd_chunked)
    cd = torch.bfloat16 if h.dtype == torch.bfloat16 else ct
    if cache is None:
        y, _ = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, compute_dtype=cd)
        new_cache = None
    else:
        # a served prompt (or a decode step) runs as one chunk
        y, S = ssd_chunked(xh, dt, A, Bm, Cm, chunk=max(L, 1),
                           initial_state=cache["S"], compute_dtype=cd)
        new_cache = {"conv": new_conv, "S": S}

    y = y + params["D_skip"][None, None, :, None] * xh.to(ct)
    y = y.reshape(Bsz, L, Di).to(h.dtype)
    y = y * torch.nn.functional.silu(z.to(ct)).to(h.dtype)
    y = rmsnorm(y, params["norm"])
    return y @ params["out_proj"], new_cache
