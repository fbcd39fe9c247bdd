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

The weights are trainable parameters.  Outside autograd (serving, under
``torch.inference_mode()``) the prefill, no-cache and cross-attention run
the hand-written kernel (``kernels/flash_attention.py``) on CUDA tensors
and raise if it fails, and ``chunked_attention``, its plain version, on
CPU tensors.  Under autograd they run ``chunked_attention`` on any device,
the function the JAX package differentiates (``_attend`` decides, in one
place).  Decode self-attention over the cache is plain PyTorch on either
device, as the JAX package leaves it to XLA outside any kernel.

On ``DTensor`` weights (a device mesh, ``transformer.set_mesh``) two
places redistribute where DTensor cannot follow GSPMD: a projection
whose head count does not divide the mesh dimension its columns are
sharded over is replicated there before the head reshape
(``_split_heads``), and the loss's reductions over the vocab run as
partial sums (``gather_last``, ``logsumexp_last``); every weight is
gathered over the dp axes where a product uses it (``gather_weight``).
None of it runs on plain tensors.
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


def rope_half_tables(positions: torch.Tensor, d: int, theta: float,
                     dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [B, S, 1, d/2] of the halves-rotated RoPE at
    ``positions`` [B, S], in f32 (float64 for a float64 model's ``dtype``):
    computed once a step and shared by every attention of the step."""
    ct = _acc(dtype)
    freqs = rope_freqs(d, theta, positions.device).to(ct)  # [d/2]
    ang = positions[..., None].to(ct) * freqs  # [B, S, d/2]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope_half(x: torch.Tensor, tables: tuple) -> torch.Tensor:
    """RoPE with the head's halves rotated (``transformers``'
    ``rotate_half``: pair i is (x[i], x[i + d/2])), as Zamba2 applies it,
    on the tables of ``rope_half_tables``; rotated in their type and cast
    back."""
    cos, sin = tables
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].to(cos.dtype), x[..., d // 2:].to(cos.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


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
    sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                          device=x.device)
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


def _is_dtensor(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _replicate_uneven(t, dim: int, n: int):
    """A DTensor with dimension ``dim`` (n groups of columns) sharded over
    a mesh dimension whose size does not divide ``n``, replicated on that
    mesh dimension (GSPMD's all-gather; DTensor cannot unflatten an
    uneven shard)."""
    from torch.distributed.tensor import Replicate

    dim = dim % t.ndim
    mesh = t.device_mesh
    want = tuple(Replicate() if p.is_shard(dim) and n % mesh.size(i) else p
                 for i, p in enumerate(t.placements))
    return t if want == tuple(t.placements) else t.redistribute(mesh, want)


def gather_weight(w: torch.Tensor) -> torch.Tensor:
    """A weight as a product uses it: on a DTensor, replicated over every
    mesh dimension but ``model`` (the FSDP all-gather GSPMD inserts; its
    backward reduce-scatters the gradient), so that the product keeps the
    activations' batch sharding and the weight's tensor-parallel one.
    Plain tensors pass through."""
    if not _is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    mesh = w.device_mesh
    want = tuple(p if name == "model" else Replicate()
                 for name, p in zip(mesh.mesh_dim_names, w.placements))
    return w if want == tuple(w.placements) else w.redistribute(mesh, want)


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's output summed over the shards it is
    partial on (GSPMD's all-reduce of the output of a product over a
    sharded contraction); plain tensors pass through."""
    if not _is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if p.is_partial() else p for p in t.placements)
    return t.redistribute(t.device_mesh, want)


def _split_heads(t: torch.Tensor, B: int, S: int, H: int, dh: int) -> torch.Tensor:
    """[B, S, H * dh] -> [B, S, H, dh]; a DTensor first has its columns
    replicated wherever H heads do not divide their shards."""
    if _is_dtensor(t):
        t = _replicate_uneven(t, -1, H)
    return t.reshape(B, S, H, dh)


def _sharded_last(x) -> bool:
    """True for a DTensor whose last dim is sharded over the mesh."""
    return _is_dtensor(x) and any(p.is_shard(x.ndim - 1) for p in x.placements)


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` per position (``torch.gather`` over the last dim).
    On a DTensor whose last dim is sharded, the JAX package's masked
    reduction instead (an iota compare, summed: the same value, one entry
    plus zeros), which reduces locally and sums a partial over the
    shards, where a gather would all-gather ``x``."""
    if not _sharded_last(x):
        return torch.gather(x, -1, idx[..., None].long())[..., 0]
    iota = torch.arange(x.shape[-1], device=x.device)
    return reduce_partial(torch.sum(torch.where(iota == idx[..., None], x, 0.0), dim=-1))


def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the last dim; on a DTensor whose last dim is
    sharded, as max, exp and sum, each of which DTensor reduces over the
    shards as a partial."""
    if not _sharded_last(x):
        return torch.logsumexp(x, dim=-1)
    m = reduce_partial(torch.amax(x, dim=-1, keepdim=True).detach())
    return torch.log(reduce_partial(torch.sum(torch.exp(x - m), dim=-1))) + m[..., 0]


def _kv_for_heads(q, k, v):
    """k, v for attention with q.  On DTensors whose q heads are sharded
    over a mesh dimension that the kv heads do not divide, k and v are
    repeated to q's heads and laid out as q (GQA computed as MHA: the same
    products, each device its own heads), where GSPMD would tile the
    (kv head, group) pair over one axis, which DTensor cannot express."""
    if not _is_dtensor(q) or k.shape[2] == q.shape[2]:
        return k, v
    mesh, Hq, Hkv = q.device_mesh, q.shape[2], k.shape[2]
    if not any(p.is_shard(2) and Hkv % mesh.size(i) for i, p in enumerate(q.placements)):
        return k, v

    def repeat(t):
        B, S, _, d = t.shape
        t = _replicate_uneven(t, 2, Hkv)
        t = t[:, :, :, None, :].expand(B, S, Hkv, Hq // Hkv, d).reshape(B, S, Hq, d)
        return t.redistribute(mesh, q.placements)

    return repeat(k), repeat(v)


def _merge_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, S, Hq, d] -> [B, S, Hkv, G, d] (a DTensor's heads replicated
    first where Hkv does not divide their shards)."""
    if _is_dtensor(q):
        q = _replicate_uneven(q, 2, n_kv)
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
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax (flash) attention by a loop over KV chunks.

    q: [B, Sq, Hkv, G, d]; k: [B, Skv, Hkv, d]; v: [B, Skv, Hkv, dv] (dv may
    differ from d: MLA's 192 / 128).  Returns [B, Sq, Hkv, G, dv].
    ``q_offset`` is the absolute position of q[0] (for causal masking
    during chunked prefill / decode).  Scores are scaled by ``scale``
    (default 1/sqrt(d)), rounded to f32.  Memory: O(Sq * kv_chunk) per
    head.  The plain version of the flash kernel.
    """
    B, Sq, Hkv, G, d = q.shape
    Skv = k.shape[1]
    scale = _f32_scalar(1.0 / np.sqrt(np.float32(d)) if scale is None else scale)
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
    acc = torch.zeros((B, Sq, Hkv, G, v.shape[-1]), dtype=ct, device=dev)
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


def _attend(q, k, v, causal: bool, cfg: ArchConfig,
            scale: Optional[float] = None,
            kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, S, Hq, d] over k, v [B, Skv, Hkv, d], scores scaled by
    ``scale`` (default 1/sqrt(d)), over the first ``kv_len`` key rows where
    that device int is given (the kernel reads it; on the CPU the rows are
    cut first): ``chunked_attention``
    with the config's chunk and score dtype under autograd (grad mode on
    and an input that requires grad) on any device, since the flash kernel
    has no backward, and on the CPU; the flash kernel (f32 scores) on CUDA
    tensors otherwise.  The one place the training and serving paths of
    attention part."""
    if _is_dtensor(q):
        return _attend_local(q, k, v, causal, cfg)
    training = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if kv_len is not None and (training or q.device.type == "cpu"):
        n = int(kv_len.reshape(-1)[0])
        k, v = k[:, :n], v[:, :n]
    if training or q.device.type == "cpu":
        return flash_lib.flash_attention_plain(
            q, k, v, causal, kv_chunk=cfg.kv_chunk,
            bf16_scores=cfg.attn_bf16_scores, scale=scale)
    if cfg.attn_bf16_scores:
        raise NotImplementedError(
            "the flash kernel computes f32 scores; bf16 scores "
            "(attn_bf16_scores) run on the CPU only")
    kw = {name: val for name, val in (("scale", scale), ("kv_len", kv_len)) if val is not None}
    return flash_lib.flash_attention(q, k, v, causal, **kw)


def cached_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig,
                  scale: float, kv: Optional[dict]) -> torch.Tensor:
    """A step's attention, q [B, S, Hq, d] over its k, v [B, S, Hkv, d],
    through a KV cache ``kv`` ({'k', 'v'} [B, max_len, Hkv, d]) where one
    is given: a prefill ('len' 0) writes rows 0..S-1 and attends causally
    over the prompt; a decode step (kv 'pos' int64 [1] and 'kv_len' int32
    [1] on the device, S == 1) writes row 'pos' and attends the cache's
    first 'kv_len' rows, which the flash kernel reads itself (plain
    attention on CPU tensors).  Without a cache, causal attention over the
    step.  The published models' attention (Zamba2's shared blocks,
    Granite 4.0-H's attention layers)."""
    if kv is not None and "pos" in kv:
        kv["k"].index_copy_(1, kv["pos"], k)
        kv["v"].index_copy_(1, kv["pos"], v)
        return _attend(q, kv["k"], kv["v"], False, cfg, scale=scale, kv_len=kv["kv_len"])
    if kv is not None:
        if kv["len"]:
            raise ValueError("a prefill fills an empty cache; a decode step "
                             "gives its position")
        S = q.shape[1]
        kv["k"][:, :S] = k
        kv["v"][:, :S] = v
    return _attend(q, k, v, True, cfg, scale=scale)


def _attend_local(q, k, v, causal: bool, cfg: ArchConfig):
    """``_attend`` on DTensors: each device attends its own batch rows and
    heads (a ``local_map`` in q's layout, k and v brought to it), since
    DTensor cannot follow the einsums' merged (batch, head) dims."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in q.placements)
    return local_map(lambda a, b, c: _attend(a, b, c, causal, cfg), out_placements=list(pl),
                     in_placements=(pl, pl, pl), device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)


def _seq_shard(t) -> tuple:
    """(offset, length) of this device's slice of a DTensor cache's
    sequence dim (dim 1)."""
    n, off = t.shape[1], 0
    coord = t.device_mesh.get_coordinate()
    for i, p in enumerate(t.placements):
        if p.is_shard(1):
            n //= t.device_mesh.size(i)
            off = off * t.device_mesh.size(i) + coord[i]
    return off * n, n


def _cache_write(cache, new, idx: int) -> None:
    """cache[:, idx : idx + S] = new, in place.  On a DTensor cache (its
    sequence sharded over the mesh) each device writes the positions of
    the step that fall in its own slice, from ``new`` laid out as the
    cache with the sequence replicated."""
    S = new.shape[1]
    if not _is_dtensor(cache):
        cache[:, idx : idx + S] = new
        return
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    pl = tuple(Replicate() if p.is_shard(1) else p for p in cache.placements)
    new = new.redistribute(mesh, pl).to_local()
    local = cache.to_local()
    off, n = _seq_shard(cache)
    a, b = max(idx, off), min(idx + S, off + n)
    if a < b:
        local[:, a - off : b - off] = new[:, a - idx : b - idx]


def _decode_attend_local(q, ck, cv, idx: int):
    """Decode attention of q [B, S, Hq, d] over a DTensor cache whose
    sequence is sharded over the mesh (the JAX package's SP cache rule):
    each device scores its own slice of positions, and the softmax's max,
    its sum and the weighted values are reduced over the sequence's mesh
    dims (flash-decode; GSPMD's partial reductions), f32 throughout."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = ck.device_mesh
    seq_dims = [i for i, p in enumerate(ck.placements) if p.is_shard(1)]
    names = mesh.mesh_dim_names
    groups = [mesh.get_group(names[i]) for i in seq_dims]
    q_pl = tuple(Replicate() if p.is_shard(1) else p for p in ck.placements)
    B, S, Hq, dh = q.shape
    Hkv = ck.shape[2]
    off, _ = _seq_shard(ck)

    def attend(ql, kl, vl):
        ct = _acc(ql.dtype)
        n_loc = kl.shape[1]
        qg = ql.reshape(ql.shape[0], S, Hkv, Hq // Hkv, dh).to(ct)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kl.to(ct))
        s = s / _f32_scalar(np.sqrt(np.float32(dh)))
        kv_pos = off + torch.arange(n_loc, device=ql.device)
        q_pos = idx + torch.arange(S, device=ql.device)
        valid = (kv_pos[None, :] <= q_pos[:, None])[None, :, None, None, :]
        s = torch.where(valid, s, -math.inf)
        m = s.amax(dim=-1)
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
        p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
        l, o = p.sum(dim=-1), torch.einsum("bqhgk,bkhd->bqhgd", p, vl.to(ct))
        for g in groups:
            l, o = funcol.all_reduce(l, "sum", g), funcol.all_reduce(o, "sum", g)
        return (o / l[..., None]).to(ql.dtype).reshape(ql.shape)

    return local_map(attend, out_placements=list(q_pl),
                     in_placements=(q_pl, tuple(ck.placements), tuple(cv.placements)),
                     device_mesh=mesh, redistribute_inputs=True)(q, ck, cv)


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

    * training-path forward: kv_cache is None -> ``chunked_attention``
      under autograd, the flash kernel on the card outside it (``_attend``).
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
    params = {k: gather_weight(w) for k, w in params.items()}
    q = _split_heads(x @ params["wq"], B, S, Hq, dh)
    if cross_kv is None:
        k = _split_heads(x @ params["wk"], B, S, Hkv, dh)
        v = _split_heads(x @ params["wv"], B, S, Hkv, dh)
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
        _cache_write(ck, k, idx)
        _cache_write(cv, v, idx)
        new_cache = {"k": ck, "v": cv, "len": idx + S}
        if S > 1:
            # prefill (assumes an empty cache, idx == 0): causal flash
            # attention over the prompt only
            o = _attend(q, *_kv_for_heads(q, k, v), True, cfg)
        elif _is_dtensor(ck):
            o = _decode_attend_local(q, ck, cv, idx)
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
        o = _attend(q, *_kv_for_heads(q, k, v), causal and cross_kv is None, cfg)
    o = o.reshape(B, S, Hq * dh)
    return reduce_partial(o @ params["wo"]), new_cache


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
    params = {k: gather_weight(w) for k, w in params.items()}
    g = torch.nn.functional.silu((x @ params["w_gate"]).to(_acc(x.dtype))).to(x.dtype)
    return reduce_partial((g * (x @ params["w_up"])) @ params["w_down"])


def gelu_mlp(params: dict, x: torch.Tensor,
             adapter: Optional[tuple] = None) -> torch.Tensor:
    """The gated-GELU MLP beside SwiGLU (Zamba2's): ``w_gate_up`` [D, 2F]
    gives gate and up in one product, plus ``(x @ a) @ b`` where
    ``adapter`` = (a [D, r], b [r, 2F]) is given; out = (gelu(gate) * up)
    @ ``w_down``, the GELU the exact (erf) one, in f32."""
    gu = x @ params["w_gate_up"]
    if adapter is not None:
        gu = gu + (x @ adapter[0]) @ adapter[1]
    gate, up = gu.chunk(2, dim=-1)
    g = torch.nn.functional.gelu(gate.to(_acc(x.dtype))).to(x.dtype)
    return (g * up) @ params["w_down"]


# --------------------------------------------------------------------------
# Modules over the functions
# --------------------------------------------------------------------------
class _Weights(nn.Module):
    """Holds a dict of weights as trainable parameters; ``params()`` gives
    the dict back for the functions above."""

    def __init__(self, weights: dict):
        super().__init__()
        for name, w in weights.items():
            self.register_parameter(name, nn.Parameter(w))

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
