"""Model assembly for every LM family, and its serving entry points.

Port of the JAX package's ``models/transformer.py``:
  dense / vlm : pre-norm GQA transformer (RoPE or M-RoPE), SwiGLU MLP
  moe         : the same, the MLP replaced by the MoE FFN (``models/moe.py``)
  ssm         : a stack of mamba2 blocks (``models/ssm.py``), no attention
  hybrid      : mamba2 backbone + ONE shared attention block applied every
                ``attn_every`` layers with per-application LoRA on W_q
                (zamba2)
  audio       : whisper-style encoder-decoder over frame embeddings (the
                conv frontend is a stub: callers pass the frames)

``init_params`` builds a ``Transformer`` module (``ModuleList``s of
``Block``s over the JAX layout), ``forward`` gives logits, ``init_cache``,
``decode_step`` and ``prefill`` serve with per-layer KV and state caches.
The JAX package stacks the layers' weights on a leading axis and scans over
them; here the blocks are a Python loop over modules, and
``params_from_jax`` / ``params_to_numpy`` carry the stacked trees across
both ways.  The caches are updated in place (their 'len' is a Python int)
where the JAX package returns new ones.

The JAX package's mesh hooks (``set_mesh``, ``_constrain_tokens``) pin
activation sharding on a device mesh and route the MoE FFN through its
expert-parallel ``shard_map``; one card has no mesh, so they have no
counterpart and every expert runs on this device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig

# leaves the JAX package keeps in float32 whatever the model's dtype
_F32_LEAVES = frozenset({"router", "A_log", "D_skip", "dt_bias"})
# trees whose leaves carry the layer on their leading axis
_STACKED = ("blocks", "enc_blocks", "cross_blocks")


class Block(nn.Module):
    """One layer's weights as modules, named as in the JAX tree: ``norm*``
    an ``RMSNorm``, ``attn`` an ``Attention``, ``mlp`` an ``MLP``, any
    other dict (``moe``, ``ssm``, ``lora``) a holder of frozen weights.
    Decoder blocks hold norm1/norm2/attn/(mlp|moe), SSM blocks norm1/ssm,
    whisper's cross blocks norm/attn, zamba2's shared block
    norm1/norm2/attn/mlp/lora.  It holds weights only: the family loops
    apply it through ``_dense_block``, ``_ssm_layer`` or ``_shared_attn``."""

    def __init__(self, weights: dict, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        for name, w in weights.items():
            if name.startswith("norm"):
                self.add_module(name, L.RMSNorm(w))
            elif name == "attn":
                self.add_module(name, L.Attention(w, cfg))
            elif name == "mlp":
                self.add_module(name, L.MLP(w))
            else:
                self.add_module(name, L._Weights(w))

    def tree(self) -> dict:
        """The JAX layout of this layer: a nested dict of tensors."""
        return {name: m.gamma if isinstance(m, L.RMSNorm) else m.params()
                for name, m in self.named_children()}


class Transformer(nn.Module):
    """The LM: embedding, blocks, final norm, LM head (untied); zamba2's
    shared attention block; whisper's encoder and cross-attention blocks."""

    def __init__(self, weights: dict, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(weights["embed"], requires_grad=False)
        self.lm_head = nn.Parameter(weights["lm_head"], requires_grad=False)
        self.final_norm = L.RMSNorm(weights["final_norm"])
        self.blocks = nn.ModuleList(Block(b, cfg) for b in weights["blocks"])
        self.shared_attn = (Block(weights["shared_attn"], cfg)
                            if cfg.family == "hybrid" else None)
        if cfg.family == "audio":
            self.enc_blocks = nn.ModuleList(Block(b, cfg) for b in weights["enc_blocks"])
            self.enc_norm = L.RMSNorm(weights["enc_norm"])
            self.cross_blocks = nn.ModuleList(
                Block(b, cfg) for b in weights["cross_blocks"])

    def forward(self, tokens: torch.Tensor, positions=None, frames=None) -> torch.Tensor:
        return forward(self, tokens, positions=positions, frames=frames)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _ones(cfg: ArchConfig, n: int, device) -> torch.Tensor:
    return torch.ones((n,), dtype=L._dtype(cfg), device=device)


def _init_block(generator: torch.Generator, cfg: ArchConfig, device) -> dict:
    """One decoder block's weights (family-dependent)."""
    D = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        return {"norm1": _ones(cfg, D, device),
                "ssm": ssm_lib.init_ssm_block(generator, cfg, device=device)}
    blk = {
        "norm1": _ones(cfg, D, device),
        "norm2": _ones(cfg, D, device),
        "attn": L.init_attention(generator, cfg, device=device),
    }
    if cfg.family == "moe":
        blk["moe"] = moe_lib.init_moe(generator, cfg, device=device)
    else:
        blk["mlp"] = L.init_mlp(generator, cfg, device=device)
    return blk


def _n_attn_apps(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def _init_shared_attn(generator: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Zamba2's shared attention+MLP block and its per-application LoRA on
    W_q: a_q N(0, 0.02^2), b_q zeros, as in the JAX package."""
    n_apps = _n_attn_apps(cfg)
    r = max(cfg.shared_attn_lora_rank, 1)
    dt = L._dtype(cfg)
    Hq = cfg.n_heads * cfg.d_head
    blk = {
        "norm1": _ones(cfg, cfg.d_model, device),
        "norm2": _ones(cfg, cfg.d_model, device),
        "attn": L.init_attention(generator, cfg, device=device),
        "mlp": L.init_mlp(generator, cfg, device=device),
    }
    a_q = torch.randn((n_apps, cfg.d_model, r), generator=generator, device=device)
    blk["lora"] = {"a_q": (a_q * 0.02).to(dt),
                   "b_q": torch.zeros((n_apps, r, Hq), dtype=dt, device=device)}
    return blk


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                device) -> Transformer:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live on that device), in the JAX package's distributions: embedding
    N(0, 0.02), projections N(0, 1/fan_in) (experts N(0, 1/E), as its
    ``dense_init`` reads the leading axis), norms 1, SSM gains as
    initialised there."""
    dt = L._dtype(cfg)
    V, D = cfg.vocab_padded, cfg.d_model
    weights = {
        "embed": (torch.randn((V, D), generator=generator, device=device)
                  * 0.02).to(dt),
        "lm_head": L.dense_init(generator, (D, V), dt, device=device),
        "final_norm": _ones(cfg, D, device),
        "blocks": [_init_block(generator, cfg, device)
                   for _ in range(cfg.n_layers)],
    }
    if cfg.family == "hybrid":
        weights["shared_attn"] = _init_shared_attn(generator, cfg, device)
    if cfg.family == "audio":
        weights["enc_blocks"] = [{
            "norm1": _ones(cfg, D, device),
            "norm2": _ones(cfg, D, device),
            "attn": L.init_attention(generator, cfg, device=device),
            "mlp": L.init_mlp(generator, cfg, device=device),
        } for _ in range(cfg.enc_layers)]
        weights["enc_norm"] = _ones(cfg, D, device)
        weights["cross_blocks"] = [{
            "norm": _ones(cfg, D, device),
            "attn": L.init_attention(generator, cfg, device=device),
        } for _ in range(cfg.n_layers)]
    return Transformer(weights, cfg)


def params_from_jax(tree: dict, cfg: ArchConfig, device) -> Transformer:
    """The JAX package's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) -> a ``Transformer`` on ``device``.  The stacked
    trees' leaves (``blocks``, ``enc_blocks``, ``cross_blocks``) carry the
    layer on their leading axis and are unstacked; every leaf comes across
    through float32 (exact for bf16) and is stored in ``cfg.dtype``, or in
    float32 where the JAX package keeps it so (router, SSM gains)."""
    dt = L._dtype(cfg)
    device = torch.device(device)

    def conv(name, x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=device, dtype=torch.float32 if name in _F32_LEAVES else dt)

    def whole(sub, name=""):
        if isinstance(sub, dict):
            return {k: whole(v, k) for k, v in sub.items()}
        return conv(name, sub)

    def layer(sub, i, name=""):
        if isinstance(sub, dict):
            return {k: layer(v, i, k) for k, v in sub.items()}
        return conv(name, np.asarray(sub)[i])

    weights = {}
    for key, sub in tree.items():
        if key in _STACKED:
            n = len(np.asarray(next(iter(_leaves(sub)))))
            weights[key] = [layer(sub, i) for i in range(n)]
        else:
            weights[key] = whole(sub, key)
    return Transformer(weights, cfg)


def _leaves(sub):
    if isinstance(sub, dict):
        for v in sub.values():
            yield from _leaves(v)
    else:
        yield sub


def weights(model: Transformer, fn=lambda t: t) -> dict:
    """The model's weights as ``Transformer`` takes them (the JAX tree with
    each stacked tree a list of layers), each tensor passed through
    ``fn``: ``Transformer(weights(m, lambda t: t.to("cpu", torch.float64)),
    cfg)`` copies a model one tensor at a time."""
    def tree(t):
        return {k: tree(v) for k, v in t.items()} if isinstance(t, dict) else fn(t)

    out = {"embed": fn(model.embed), "lm_head": fn(model.lm_head),
           "final_norm": fn(model.final_norm.gamma)}
    for key in _STACKED:
        if hasattr(model, key):
            out[key] = [tree(b.tree()) for b in getattr(model, key)]
    if model.shared_attn is not None:
        out["shared_attn"] = tree(model.shared_attn.tree())
    if hasattr(model, "enc_norm"):
        out["enc_norm"] = fn(model.enc_norm.gamma)
    return out


def params_to_numpy(model: Transformer) -> dict:
    """Inverse of ``params_from_jax``: the JAX package's tree of float32
    numpy arrays, the layer on the stacked trees' leading axis."""
    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return np.stack(items)

    w = weights(model, lambda t: t.detach().to(torch.float32).cpu().numpy())
    return {k: stack(v) if k in _STACKED else v for k, v in w.items()}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _dense_block(blk: Block, h, positions, causal=True, cross=None, kv_cache=None):
    """Attention, whisper's cross-attention where ``cross`` = (cross
    block, k, v), then the MLP or the MoE FFN."""
    cfg = blk.cfg
    a, new_cache = blk.attn(blk.norm1(h), positions, causal=causal,
                            kv_cache=kv_cache)
    h = h + a
    if cross is not None:
        xblk, xk, xv = cross
        c, _ = xblk.attn(xblk.norm(h), positions, causal=False, cross_kv=(xk, xv))
        h = h + c
    if cfg.family == "moe":
        h = h + moe_lib.moe_apply(blk.norm2(h), blk.moe.params(), cfg)
    else:
        h = h + blk.mlp(blk.norm2(h))
    return h, new_cache


def _ssm_layer(blk: Block, h, cache=None):
    y, new_cache = ssm_lib.ssm_block_apply(blk.ssm.params(), blk.norm1(h), blk.cfg,
                                           cache=cache)
    return h + y, new_cache


def _shared_attn(model: Transformer, h, positions, app: int, kv_cache=None):
    """Zamba2's shared block at application ``app``: attention with that
    application's LoRA delta on W_q, then the MLP."""
    sh = model.shared_attn
    lora = sh.lora.params()
    attn_p = dict(sh.attn.params())
    attn_p["wq"] = attn_p["wq"] + lora["a_q"][app] @ lora["b_q"][app]
    a, new_cache = L.attention(attn_p, sh.norm1(h), model.cfg, positions,
                               kv_cache=kv_cache)
    h = h + a
    return h + sh.mlp(sh.norm2(h)), new_cache


def _hybrid_layers(model: Transformer, h, positions, cache=None):
    """Zamba2: every ``attn_every`` mamba blocks, the shared attention
    block; the trailing ``n_layers % attn_every`` blocks after the last.
    With a cache, each layer's conv and SSM states and each application's
    KV are written into it."""
    cfg = model.cfg
    per = cfg.attn_every
    n_super = _n_attn_apps(cfg) * per
    for i, blk in enumerate(model.blocks):
        h = _ssm_step(blk, h, cache, i)
        if i < n_super and (i + 1) % per == 0:
            app = i // per
            kv = None if cache is None else {
                "k": cache["k"][app], "v": cache["v"][app], "len": cache["len"]}
            h, _ = _shared_attn(model, h, positions, app, kv_cache=kv)
    return h


def _ssm_step(blk: Block, h, cache, i: int):
    """One mamba layer; with a cache, its layer ``i`` states are read and
    replaced in place."""
    if cache is None:
        return _ssm_layer(blk, h)[0]
    h, nc = _ssm_layer(blk, h, cache={"conv": cache["conv"][i], "S": cache["S"][i]})
    cache["conv"][i].copy_(nc["conv"])
    cache["S"][i].copy_(nc["S"])
    return h


def _encode_audio(model: Transformer, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over frame embeddings [B, T_enc, D]: non-causal
    self-attention (the flash kernel on the card) and the MLP per layer."""
    B, T_enc, _ = frames.shape
    pos = _positions(0, B, T_enc, frames.device)
    h = frames
    for blk in model.enc_blocks:
        h, _ = _dense_block(blk, h, pos, causal=False)
    return model.enc_norm(h)


def _cross_kv(model: Transformer, enc: torch.Tensor, i: int):
    """Layer ``i``'s cross-attention K, V [B, T_enc, Hkv, d] of the
    encoder output."""
    cfg = model.cfg
    B, T_enc, _ = enc.shape
    p = model.cross_blocks[i].attn.params()
    shape = (B, T_enc, cfg.n_kv_heads, cfg.d_head)
    return (enc @ p["wk"]).reshape(shape), (enc @ p["wv"]).reshape(shape)


def _positions(start: int, batch: int, seq: int, device, mrope: bool = False) -> torch.Tensor:
    pos = (start + torch.arange(seq, device=device)).expand(batch, seq)
    return pos.expand(3, batch, seq) if mrope else pos


def forward(model: Transformer, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token logits [B, S, V_padded] (training / prefill path, no caches).
    ``positions`` [B, S] ([3, B, S] for M-RoPE) default to 0..S-1 on every
    stream; the audio family needs ``frames`` [B, T_enc, D]."""
    cfg = model.cfg
    B, S = tokens.shape
    h = model.embed[tokens]  # gather
    if positions is None:
        positions = _positions(0, B, S, tokens.device, cfg.mrope)
    if cfg.family in ("dense", "vlm", "moe"):
        for blk in model.blocks:
            h, _ = _dense_block(blk, h, positions)
    elif cfg.family == "ssm":
        for blk in model.blocks:
            h, _ = _ssm_layer(blk, h)
    elif cfg.family == "hybrid":
        h = _hybrid_layers(model, h, positions)
    elif cfg.family == "audio":
        if frames is None:
            raise ValueError("audio family needs `frames` (stub embeddings)")
        enc = _encode_audio(model, frames)
        for i, (blk, xblk) in enumerate(zip(model.blocks, model.cross_blocks)):
            h, _ = _dense_block(blk, h, positions, cross=(xblk, *_cross_kv(model, enc, i)))
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    h = model.final_norm(h)
    return h @ model.lm_head


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device,
               enc_len: int = 0, dtype: Optional[torch.dtype] = None) -> dict:
    """Decode caches, 'len' (a Python int) the number of positions filled:
    per-layer KV [L, B, max_len, Hkv, d_head] for the attention families;
    per-layer conv [L, B, CONV_K - 1, d_inner + 2 N] and SSM state
    [L, B, H, N, head_dim] (f32, or float64 for a float64 model) for SSM
    and hybrid, with the hybrid's KV per shared-block application; and
    whisper's cross K, V [L, B, enc_len, Hkv, d_head].  ``dtype`` is the
    weights' (default ``cfg.dtype``)."""
    dt = dtype or L._dtype(cfg)
    z = dict(dtype=dt, device=device)
    Lr = cfg.n_layers

    def kv(n, length):
        return torch.zeros((n, batch, length, cfg.n_kv_heads, cfg.d_head), **z)

    if cfg.family in ("dense", "vlm", "moe"):
        return {"k": kv(Lr, max_len), "v": kv(Lr, max_len), "len": 0}
    if cfg.family in ("ssm", "hybrid"):
        cache = {
            "conv": torch.zeros((Lr, batch, ssm_lib.CONV_K - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state), **z),
            "S": torch.zeros((Lr, batch, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), dtype=L._acc(dt), device=device),
            "len": 0,
        }
        if cfg.family == "hybrid":
            n_apps = _n_attn_apps(cfg)
            cache.update(k=kv(n_apps, max_len), v=kv(n_apps, max_len))
        return cache
    if cfg.family == "audio":
        return {"k": kv(Lr, max_len), "v": kv(Lr, max_len),
                "xk": kv(Lr, enc_len), "xv": kv(Lr, enc_len), "len": 0}
    raise ValueError(cfg.family)


def decode_step(model: Transformer, cache: dict,
                tokens: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """One decode step: tokens [B, S] -> (updated cache, logits [B, S, V]).

    S == 1 attends to the cache; S > 1 is the prefill of an empty cache.
    The cache's tensors are updated in place.
    """
    cfg = model.cfg
    B, S = tokens.shape
    h = model.embed[tokens]
    idx = cache["len"]
    pos = _positions(idx, B, S, tokens.device, cfg.mrope)

    def kv(i):
        return {"k": cache["k"][i], "v": cache["v"][i], "len": idx}

    if cfg.family in ("dense", "vlm", "moe"):
        for i, blk in enumerate(model.blocks):
            h, _ = _dense_block(blk, h, pos, kv_cache=kv(i))
    elif cfg.family == "ssm":
        for i, blk in enumerate(model.blocks):
            h = _ssm_step(blk, h, cache, i)
    elif cfg.family == "hybrid":
        h = _hybrid_layers(model, h, pos, cache=cache)
    elif cfg.family == "audio":
        for i, (blk, xblk) in enumerate(zip(model.blocks, model.cross_blocks)):
            h, _ = _dense_block(blk, h, pos, kv_cache=kv(i),
                                cross=(xblk, cache["xk"][i], cache["xv"][i]))
    else:
        raise ValueError(cfg.family)
    new_cache = dict(cache, len=idx + S)
    h = model.final_norm(h)
    return new_cache, h @ model.lm_head


def prefill(model: Transformer, tokens: torch.Tensor, max_len: int,
            frames: Optional[torch.Tensor] = None) -> tuple[dict, torch.Tensor]:
    """Prefill a prompt and build decode caches: the decode path over the
    whole prompt at once (an S-token step), as the JAX package does; the
    audio family first encodes ``frames`` and caches each layer's cross
    K, V.  Returns (cache, logits [B, S, V_padded] at every prompt
    position)."""
    B, _ = tokens.shape
    enc_len = frames.shape[1] if frames is not None else 0
    # the caches take the weights' type (float64 for a model cast with .double())
    cache = init_cache(model.cfg, B, max_len, device=tokens.device, enc_len=enc_len,
                       dtype=model.embed.dtype)
    if model.cfg.family == "audio":
        enc = _encode_audio(model, frames)
        for i in range(model.cfg.n_layers):
            xk, xv = _cross_kv(model, enc, i)
            cache["xk"][i].copy_(xk)
            cache["xv"][i].copy_(xv)
    return decode_step(model, cache, tokens)
