"""Shared transformer layers: RMSNorm, RoPE and M-RoPE, chunked
online-softmax attention (prefill, the no-cache forward and
cross-attention), cached decode attention, SwiGLU MLP.

Port of the JAX package's ``models/layers.py``.  The layers are plain
functions over dicts of tensors, with thin ``nn.Module``s (``RMSNorm``,
``Attention``, ``MLP``) that hold the weights in the JAX layout (``x @ w``)
and call them.  Weights are stored in ``cfg.dtype``; the places of
rounding are the JAX package's: RMSNorm, RoPE and SiLU compute in f32 and
cast back, attention scores are f32.  A model whose weights were cast to
float64 computes all of these in float64 instead (``_acc``): the CPU
reference of the card's f32 check.

On CUDA tensors the prefill, no-cache and cross-attention run the
hand-written kernel (``kernels/flash_attention.py``) and raise if it
fails; on CPU tensors they run ``chunked_attention``, its plain version.
Decode self-attention over the cache is plain PyTorch on either device, as
the JAX package leaves it to XLA outside any kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import flash_attention as flash_lib
from repro_torch.models.config import ArchConfig


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type norms, RoPE, SiLU and attention scores compute in for
    tensors of ``dtype``: f32 (for f32 and bf16 alike), or f64 for a
    float64 model."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def dense_init(generator: torch.Generator, shape, dtype, scale: float = 1.0,
               *, device=None) -> torch.Tensor:
    """N(0, 1) * scale / sqrt(fan_in) drawn from ``generator`` (on its
    device), cast to ``dtype``."""
    fan_in = shape[0]
    x = torch.randn(shape, generator=generator, device=device)
    return x.mul_(scale / math.sqrt(fan_in)).to(dtype)  # in place: one f32 copy


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(_acc(x.dtype))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


# --------------------------------------------------------------------------
# RoPE / M-RoPE
# --------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (
        torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, d]; positions: [B, S] -> rotated x (interleaved pairs
    x[..., ::2], x[..., 1::2], rotated in f32)."""
    d = x.shape[-1]
    ct = _acc(x.dtype)
    freqs = rope_freqs(d, theta, x.device).to(ct)  # [d/2]
    ang = positions[..., None].to(ct) * freqs  # [B, S, d/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xf1 = x[..., ::2].to(ct)
    xf2 = x[..., 1::2].to(ct)
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: positions [3, B, S] (t, h, w streams); the
    head dim's frequency pairs are split into three sections, one per
    stream.  ``sections`` are half-dim section sizes (sum == d_head // 2).
    The JAX package picks each pair's stream by a one-hot contraction,
    which is exact; here it is an index."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    ct = _acc(x.dtype)
    freqs = rope_freqs(d, theta, x.device).to(ct)  # [d/2]
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device), torch.tensor(sections, device=x.device))
    ang_all = positions.to(ct)[..., None] * freqs  # [3, B, S, d/2]
    pair = torch.arange(d // 2, device=x.device)
    ang = ang_all.permute(1, 2, 3, 0)[:, :, pair, sec_id]  # [B, S, d/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xf1 = x[..., ::2].to(ct)
    xf2 = x[..., 1::2].to(ct)
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def _mrope_sections(d_head: int) -> tuple:
    """Qwen2-VL uses (16, 24, 24) half-dim sections for d_head=128; scale
    proportionally for other head dims."""
    half = d_head // 2
    a = half // 4
    b = (half - a) // 2
    return (a, b, half - a - b)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def init_attention(generator: torch.Generator, cfg: ArchConfig,
                   d_model: Optional[int] = None, *, device=None) -> dict:
    D = d_model or cfg.d_model
    dh, Hq, Hkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    dt = _dtype(cfg)
    p = {
        "wq": dense_init(generator, (D, Hq * dh), dt, device=device),
        "wk": dense_init(generator, (D, Hkv * dh), dt, device=device),
        "wv": dense_init(generator, (D, Hkv * dh), dt, device=device),
        "wo": dense_init(generator, (Hq * dh, D), dt, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dt, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=dt, device=device)
    return p


def _merge_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, S, Hq, d] -> [B, S, Hkv, G, d]."""
    B, S, Hq, d = q.shape
    return q.reshape(B, S, n_kv, Hq // n_kv, d)


def _f32_scalar(x: float) -> float:
    """A constant rounded to f32, as the JAX package's f32 constants are."""
    return float(np.float32(x))


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    q_offset: int = 0,
    kv_chunk: int = 1024,
    bf16_scores: bool = False,
) -> torch.Tensor:
    """Online-softmax (flash) attention by a loop over KV chunks.

    q: [B, Sq, Hkv, G, d]; k/v: [B, Skv, Hkv, d].  Returns [B, Sq, Hkv, G, d].
    ``q_offset`` is the absolute position of q[0] (for causal masking
    during chunked prefill / decode).  Memory: O(Sq * kv_chunk) per head.
    The plain version of the flash kernel.
    """
    B, Sq, Hkv, G, d = q.shape
    Skv = k.shape[1]
    scale = _f32_scalar(1.0 / np.sqrt(np.float32(d)))
    n_chunks = -(-Skv // kv_chunk)
    pad = n_chunks * kv_chunk - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)

    # scores in bf16 (optional) with f32 running max/denominator/accumulator
    ct = _acc(q.dtype)
    sd = torch.bfloat16 if bf16_scores else ct
    qs = q.to(sd)
    m = torch.full((B, Sq, Hkv, G), -math.inf, dtype=ct, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=ct, device=dev)
    acc = torch.zeros((B, Sq, Hkv, G, d), dtype=ct, device=dev)
    for c in range(n_chunks):
        kci = k[:, c * kv_chunk : (c + 1) * kv_chunk]
        vci = v[:, c * kv_chunk : (c + 1) * kv_chunk]
        kv_pos = c * kv_chunk + torch.arange(kv_chunk, device=dev)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qs, kci.to(sd)) * scale
        valid = kv_pos[None, :] < Skv  # mask kv padding
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])
        vmask = valid[None, :, None, None, :]
        s = torch.where(vmask, s, torch.tensor(-math.inf, dtype=sd, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1).to(ct))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None].to(sd))
        p = torch.where(vmask, p, torch.zeros((), dtype=sd, device=dev))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + torch.sum(p, dim=-1, dtype=ct)
        pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).to(ct),
                          vci.to(ct))
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.to(q.dtype)


def _attend(q, k, v, causal: bool, cfg: ArchConfig) -> torch.Tensor:
    """q [B, S, Hq, d] over k, v [B, Skv, Hkv, d]: ``chunked_attention``
    with the config's chunk and score dtype on the CPU, the flash kernel
    (f32 scores) anywhere else."""
    if q.device.type == "cpu":
        return flash_lib.flash_attention_plain(
            q, k, v, causal, kv_chunk=cfg.kv_chunk,
            bf16_scores=cfg.attn_bf16_scores)
    if cfg.attn_bf16_scores:
        raise NotImplementedError(
            "the flash kernel computes f32 scores; bf16 scores "
            "(attn_bf16_scores) run on the CPU only")
    return flash_lib.flash_attention(q, k, v, causal)


def attention(
    params: dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    causal: bool = True,
    kv_cache: Optional[dict] = None,
    cross_kv: Optional[tuple] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """GQA attention, all modes.

    * training-path forward: kv_cache is None -> flash attention.
    * prefill: kv_cache = {'k','v','len'} with len 0 and S > 1 -> the
      prompt's k/v written into the cache, causal flash attention over
      the prompt only.
    * decode: S == 1 -> append one step, attend to the cache.
    * cross-attention: cross_kv = (k, v) precomputed from the encoder, no
      RoPE, ``qk_norm`` on q only, non-causal flash attention.

    x: [B, S, D]; positions: [B, S] (or [3, B, S] for M-RoPE).  The cache's
    'k'/'v' are this layer's [B, max_len, Hkv, d] and are updated in place
    ('len' is a Python int).  Returns (out [B, S, D], updated kv_cache or
    None).
    """
    B, S, D = x.shape
    dh, Hq, Hkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    q = (x @ params["wq"]).reshape(B, S, Hq, dh)
    if cross_kv is None:
        k = (x @ params["wk"]).reshape(B, S, Hkv, dh)
        v = (x @ params["wv"]).reshape(B, S, Hkv, dh)
    else:
        k, v = cross_kv

    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        if cross_kv is None:
            k = rmsnorm(k, params["k_norm"])

    if cross_kv is None:  # rope only applies to self-attention
        if cfg.mrope:
            q = apply_mrope(q, positions, cfg.rope_theta, _mrope_sections(dh))
            k = apply_mrope(k, positions, cfg.rope_theta, _mrope_sections(dh))
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
        # serving: write this step's k/v into the cache at index 'len'
        idx = kv_cache["len"]
        ck, cv = kv_cache["k"], kv_cache["v"]
        ck[:, idx : idx + S] = k
        cv[:, idx : idx + S] = v
        new_cache = {"k": ck, "v": cv, "len": idx + S}
        if S > 1:
            # prefill (assumes an empty cache, idx == 0): causal flash
            # attention over the prompt only
            o = _attend(q, k, v, True, cfg)
        else:
            # decode: attend to the cache up to 'len' + S, keeping
            # causality within the step; scores in f32
            n = idx + S
            ct = _acc(q.dtype)
            qg = _merge_gqa(q, Hkv).to(ct)
            s = torch.einsum("bqhgd,bkhd->bqhgk", qg, ck[:, :n].to(ct))
            s = s / _f32_scalar(np.sqrt(np.float32(dh)))
            kv_pos = torch.arange(n, device=x.device)
            q_pos = idx + torch.arange(S, device=x.device)
            valid = kv_pos[None, :] <= q_pos[:, None]
            s = torch.where(valid[None, :, None, None, :], s, -math.inf)
            p = torch.softmax(s, dim=-1).to(cv.dtype)
            o = torch.einsum("bqhgk,bkhd->bqhgd", p, cv[:, :n])
    else:
        o = _attend(q, k, v, causal and cross_kv is None, cfg)
    o = o.reshape(B, S, Hq * dh)
    return o @ params["wo"], new_cache


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------
def init_mlp(generator: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None, *, device=None) -> dict:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg)
    return {
        "w_gate": dense_init(generator, (D, F), dt, device=device),
        "w_up": dense_init(generator, (D, F), dt, device=device),
        "w_down": dense_init(generator, (F, D), dt, device=device),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = torch.nn.functional.silu((x @ params["w_gate"]).to(_acc(x.dtype))).to(x.dtype)
    return (g * (x @ params["w_up"])) @ params["w_down"]


# --------------------------------------------------------------------------
# Modules over the functions
# --------------------------------------------------------------------------
class _Weights(nn.Module):
    """Holds a dict of weights as frozen parameters; ``params()`` gives the
    dict back for the functions above."""

    def __init__(self, weights: dict):
        super().__init__()
        for name, w in weights.items():
            self.register_parameter(name, nn.Parameter(w, requires_grad=False))

    def params(self) -> dict:
        return dict(self.named_parameters(recurse=False))


class RMSNorm(_Weights):
    def __init__(self, gamma: torch.Tensor):
        super().__init__({"gamma": gamma})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.gamma)


class Attention(_Weights):
    def __init__(self, weights: dict, cfg: ArchConfig):
        super().__init__(weights)
        self.cfg = cfg

    def forward(self, x, positions, causal=True, kv_cache=None, cross_kv=None):
        return attention(self.params(), x, self.cfg, positions, causal, kv_cache,
                         cross_kv)


class MLP(_Weights):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self.params(), x)
