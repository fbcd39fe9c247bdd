"""Model assembly of the dense family: a pre-norm GQA transformer with RoPE
and a SwiGLU MLP, and its serving entry points.

Port of the JAX package's ``models/transformer.py``, dense family only:
``init_params`` (a ``Transformer`` module with one ``ModuleList`` of
blocks), ``forward`` (logits), ``init_cache``, ``decode_step`` and
``prefill`` (serving with per-layer KV caches).  The JAX package stacks the
layers' weights on a leading axis and scans over them; here the blocks are
a Python loop over modules, and ``params_from_jax`` / ``params_to_numpy``
carry the stacked tree across.  The KV cache is updated in place (its
'len' is a Python int) where the JAX package returns a new one.

Other families (MoE, SSM, hybrid, audio, VLM) raise ``NotImplementedError``
(ROADMAP, queue 1).  The JAX package's mesh hooks (``set_mesh``,
``_constrain_tokens``) pin activation sharding on a device mesh; one card
has no mesh, so they have no counterpart.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; only the "
            f"dense family is (ROADMAP, queue 1)"
        )


class Block(nn.Module):
    """One decoder block: x + attn(norm1(x)), then + mlp(norm2(x))."""

    def __init__(self, weights: dict, cfg: ArchConfig):
        super().__init__()
        self.norm1 = L.RMSNorm(weights["norm1"])
        self.norm2 = L.RMSNorm(weights["norm2"])
        self.attn = L.Attention(weights["attn"], cfg)
        self.mlp = L.MLP(weights["mlp"])

    def forward(self, h, positions, causal=True, kv_cache=None):
        return _dense_block(self, h, positions, causal=causal, kv_cache=kv_cache)


class Transformer(nn.Module):
    """The dense LM: embedding, blocks, final norm, LM head (untied)."""

    def __init__(self, weights: dict, cfg: ArchConfig):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(weights["embed"], requires_grad=False)
        self.lm_head = nn.Parameter(weights["lm_head"], requires_grad=False)
        self.final_norm = L.RMSNorm(weights["final_norm"])
        self.blocks = nn.ModuleList(Block(b, cfg) for b in weights["blocks"])

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _init_block(generator: torch.Generator, cfg: ArchConfig, device) -> dict:
    """One decoder block's weights (dense family)."""
    dt = L._dtype(cfg)
    return {
        "norm1": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "norm2": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "attn": L.init_attention(generator, cfg, device=device),
        "mlp": L.init_mlp(generator, cfg, device=device),
    }


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                device) -> Transformer:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live on that device), in the JAX package's distributions: embedding
    N(0, 0.02), projections N(0, 1/fan_in), norms 1."""
    _check_family(cfg)
    dt = L._dtype(cfg)
    V, D = cfg.vocab_padded, cfg.d_model
    weights = {
        "embed": (torch.randn((V, D), generator=generator, device=device)
                  * 0.02).to(dt),
        "lm_head": L.dense_init(generator, (D, V), dt, device=device),
        "final_norm": torch.ones((D,), dtype=dt, device=device),
        "blocks": [_init_block(generator, cfg, device)
                   for _ in range(cfg.n_layers)],
    }
    return Transformer(weights, cfg)


def params_from_jax(tree: dict, cfg: ArchConfig, device) -> Transformer:
    """The JAX package's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) -> a ``Transformer`` on ``device``.  The blocks'
    leaves carry the layer on their leading axis and are unstacked; every
    leaf comes across through float32 (exact for bf16) and is stored in
    ``cfg.dtype``."""
    _check_family(cfg)
    dt = L._dtype(cfg)
    device = torch.device(device)

    def conv(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=device, dtype=dt)

    def f32(sub):
        if isinstance(sub, dict):
            return {k: f32(v) for k, v in sub.items()}
        return np.asarray(sub, dtype=np.float32)

    def layer(sub, i):
        if isinstance(sub, dict):
            return {k: layer(v, i) for k, v in sub.items()}
        return conv(sub[i])

    blocks = f32(tree["blocks"])
    weights = {
        "embed": conv(f32(tree["embed"])),
        "lm_head": conv(f32(tree["lm_head"])),
        "final_norm": conv(f32(tree["final_norm"])),
        "blocks": [layer(blocks, i) for i in range(cfg.n_layers)],
    }
    return Transformer(weights, cfg)


def params_to_numpy(model: Transformer) -> dict:
    """Inverse of ``params_from_jax``: the stacked tree of float32 numpy
    arrays, the layer on the blocks' leading axis."""
    def arr(t):
        return t.detach().to(torch.float32).cpu().numpy()

    def block(b: Block) -> dict:
        return {"norm1": arr(b.norm1.gamma), "norm2": arr(b.norm2.gamma),
                "attn": {k: arr(v) for k, v in b.attn.params().items()},
                "mlp": {k: arr(v) for k, v in b.mlp.params().items()}}

    per_layer = [block(b) for b in model.blocks]

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return np.stack(items)

    return {"embed": arr(model.embed), "lm_head": arr(model.lm_head),
            "final_norm": arr(model.final_norm.gamma),
            "blocks": stack(per_layer)}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _dense_block(blk: Block, h, positions, causal=True, kv_cache=None):
    a, new_cache = blk.attn(blk.norm1(h), positions, causal=causal,
                            kv_cache=kv_cache)
    h = h + a
    h = h + blk.mlp(blk.norm2(h))
    return h, new_cache


def _positions(start: int, batch: int, seq: int, device) -> torch.Tensor:
    return (start + torch.arange(seq, device=device)).expand(batch, seq)


def forward(model: Transformer, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token logits [B, S, V_padded] (training / prefill path, no caches)."""
    B, S = tokens.shape
    h = model.embed[tokens]  # gather
    if positions is None:
        positions = _positions(0, B, S, tokens.device)
    for blk in model.blocks:
        h, _ = _dense_block(blk, h, positions)
    h = model.final_norm(h)
    return h @ model.lm_head


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device) -> dict:
    """Decode caches: per-layer KV, [L, B, max_len, Hkv, d_head] each, and
    'len' (a Python int), the number of positions filled."""
    _check_family(cfg)
    dt = L._dtype(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "len": 0,
    }


def decode_step(model: Transformer, cache: dict,
                tokens: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """One decode step: tokens [B, S] -> (updated cache, logits [B, S, V]).

    S == 1 attends to the cache; S > 1 is the prefill of an empty cache.
    The cache's tensors are updated in place.
    """
    B, S = tokens.shape
    h = model.embed[tokens]
    idx = cache["len"]
    pos = _positions(idx, B, S, tokens.device)
    for i, blk in enumerate(model.blocks):
        h, _ = _dense_block(
            blk, h, pos,
            kv_cache={"k": cache["k"][i], "v": cache["v"][i], "len": idx})
    new_cache = {"k": cache["k"], "v": cache["v"], "len": idx + S}
    h = model.final_norm(h)
    return new_cache, h @ model.lm_head


def prefill(model: Transformer, tokens: torch.Tensor,
            max_len: int) -> tuple[dict, torch.Tensor]:
    """Prefill a prompt and build decode caches: the decode path over the
    whole prompt at once (an S-token step), as the JAX package does.
    Returns (cache, logits [B, S, V_padded] at every prompt position)."""
    B, _ = tokens.shape
    cache = init_cache(model.cfg, B, max_len, device=tokens.device)
    return decode_step(model, cache, tokens)
