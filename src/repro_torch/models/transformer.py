"""Model assembly for every LM family, and its serving entry points.

Port of the JAX package's ``models/transformer.py``:
  dense / vlm : pre-norm GQA transformer (RoPE or M-RoPE), SwiGLU MLP
  moe         : the same, the MLP replaced by the MoE FFN (``models/moe.py``)
  ssm         : a stack of mamba2 blocks (``models/ssm.py``), no attention
  hybrid      : mamba2 backbone + ONE shared attention block applied every
                ``attn_every`` layers with per-application LoRA on W_q
                (zamba2, the JAX package's simplified variant)
  published   : Zamba2 as published (``Zamba2Config``, zamba2-7b-instruct),
                Granite 4.0-H as published (``GraniteMoeHybridConfig``,
                granite-4.0-h-small) and DeepSeek-V3's block as published
                (``DeepseekV3Config``, kanana-2-30b-a3b-instruct) run the
                layer loops, caches and loaders of ``models/zamba2.py``,
                ``models/granite4h.py`` and ``models/deepseek_v3.py``
                (``published(cfg)``, the one place that dispatches to them)
  audio       : whisper-style encoder-decoder over frame embeddings (the
                conv frontend is a stub: callers pass the frames)

``init_params`` builds a ``Transformer`` module (``ModuleList``s of
``Block``s over the JAX layout, trainable parameters), ``forward`` gives
logits, ``loss_fn`` the training loss and ``train_step_fn`` one optimizer
step; ``init_cache``, ``decode_step`` and ``prefill`` serve with per-layer
KV and state caches.  The JAX package stacks the layers' weights on a
leading axis and scans over them; here the blocks are a Python loop over
modules, ``params_from_jax`` / ``params_to_numpy`` carry the stacked trees
across both ways, and ``param_tree`` views the model as the stacked tree
(each layer's parameter a slice of one tensor per leaf), which is what the
optimizer updates.  ``cfg.remat == 'full'`` recomputes each block in the
backward pass (``torch.utils.checkpoint``) where the JAX package
checkpoints it.  The caches are updated in place (their 'len' is a
Python int) where the JAX package returns new ones.

The mesh hooks: ``set_mesh(mesh)`` names a ``DeviceMesh`` whose axes are
the JAX package's (pod, data, model); the weights are then ``DTensor``s
laid out by ``distributed/sharding.py`` (the dry run builds them,
``launch/dryrun.py``), ``_constrain_tokens`` redistributes the tokens to
batch over the dp axes and replicated elsewhere where the JAX package
pins them with ``with_sharding_constraint``, and the MoE FFN takes its
expert-parallel branch (``moe.moe_apply``).  ``mesh_scope()`` is the
context a step on DTensor weights runs in.  Without a mesh every hook is
the identity.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import deepseek_v3 as deepseek_v3_lib
from repro_torch.models import granite4h as granite4h_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import zamba2 as zamba2_lib
from repro_torch.models.config import ArchConfig

# leaves the JAX package keeps in float32 whatever the model's dtype
_F32_LEAVES = frozenset({"router", "A_log", "D_skip", "dt_bias"})
# trees whose leaves carry the layer on their leading axis
_STACKED = ("blocks", "enc_blocks", "cross_blocks")
# the families laid out as a published checkpoint, by their model module
_PUBLISHED = {"zamba2": zamba2_lib, "granite4h": granite4h_lib,
              "deepseek_v3": deepseek_v3_lib}


def published(cfg: ArchConfig):
    """The model module of a family laid out as a published checkpoint
    (``models/zamba2.py``, ``models/granite4h.py``,
    ``models/deepseek_v3.py``), or None.  Each has
    ``init_weights``, ``weights_from_hf``, ``layers``, ``init_cache``,
    ``decode_static`` and ``decode_graph``: the one place the model code
    dispatches to them."""
    return _PUBLISHED.get(cfg.family)


class Block(nn.Module):
    """One layer's weights as modules, named as in the JAX tree: ``norm*``
    an ``RMSNorm``, ``attn`` an ``Attention``, ``mlp`` an ``MLP``, any
    other dict (``moe``, ``ssm``, ``lora``) a holder of trainable weights.
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
    """The LM: embedding, blocks, final norm, LM head (untied, or the
    embedding where ``cfg.tie_embeddings``: ``lm_head`` None); zamba2's
    shared attention block; the published Zamba2's shared blocks and
    per-application weights (``shared_blocks``, ``apps``); whisper's
    encoder and cross-attention blocks."""

    def __init__(self, weights: dict, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(weights["embed"])
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(weights["lm_head"])
        self.final_norm = L.RMSNorm(weights["final_norm"])
        self.blocks = nn.ModuleList(Block(b, cfg) for b in weights["blocks"])
        self.shared_attn = (Block(weights["shared_attn"], cfg)
                            if cfg.family == "hybrid" else None)
        if "shared_blocks" in weights:  # the published Zamba2's
            self.shared_blocks = nn.ModuleList(Block(b, cfg) for b in weights["shared_blocks"])
            self.apps = nn.ModuleList(L._Weights(a) for a in weights["apps"])
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
    initialised there.  A published layout takes its module's
    ``init_weights``."""
    lib = published(cfg)
    if lib is not None:
        return Transformer(lib.init_weights(generator, cfg, device), cfg)
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


def params_from_hf(state, cfg: ArchConfig, device=None) -> Transformer:
    """A published checkpoint's state dict (``Zamba2ForCausalLM``'s,
    ``GraniteMoeHybridForCausalLM``'s or ``DeepseekV3ForCausalLM``'s
    parameter names; any mapping, each name read once) -> a
    ``Transformer`` of ``cfg`` (a ``Zamba2Config``, a
    ``GraniteMoeHybridConfig`` or a ``DeepseekV3Config``) on ``device``,
    each weight copied in ``cfg.dtype``."""
    lib = published(cfg)
    if lib is None:
        raise ValueError(f"{cfg.name} is not a published layout (Zamba2, Granite 4.0-H, "
                         f"DeepSeek-V3)")
    return Transformer(lib.weights_from_hf(state, cfg, device), cfg)


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

    out = {"embed": fn(model.embed), "final_norm": fn(model.final_norm.gamma)}
    if model.lm_head is not None:
        out["lm_head"] = fn(model.lm_head)
    for key in _STACKED:
        if hasattr(model, key):
            out[key] = [tree(b.tree()) for b in getattr(model, key)]
    if hasattr(model, "shared_blocks"):
        out["shared_blocks"] = [tree(b.tree()) for b in model.shared_blocks]
        out["apps"] = [tree(a.params()) for a in model.apps]
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
        h = h + moe_lib.moe_apply(blk.norm2(h), blk.moe.params(), cfg, mesh=_MESH[0])
    else:
        h = h + blk.mlp(blk.norm2(h))
    return h, new_cache


# The device mesh of the weights' DTensors, set by the dry run through
# ``set_mesh`` (None: plain tensors, every hook the identity).
_MESH: list = [None]


def set_mesh(mesh) -> None:
    _MESH[0] = mesh


def _constrain_tokens(h):
    """Pin the activations' layout: batch over (pod, data), or the largest
    prefix of them that divides it, replicated on every other mesh
    dimension, in the forward pass and for the gradient in the backward
    pass, as the JAX package's ``with_sharding_constraint`` pins both
    (without it the embedding table's layout would leave the batch
    replicated, every device doing the dp axes' work; DTensor's
    elementwise rules would let a replicated gradient replicate the
    activations' gradients).  The identity without a mesh or on a plain
    tensor."""
    mesh = _MESH[0]
    if mesh is None:
        return h
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import sharding

    if not isinstance(h, DTensor):
        return h
    axes = sharding.fit_axes(h.shape[0], mesh, sharding.dp_axes(mesh)) or ()
    want = tuple(Shard(0) if a in axes else Replicate()
                 for a in sharding.axis_names(mesh))
    return _Constrain.apply(h, want)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``want``, and its gradient too."""

    @staticmethod
    def forward(ctx, h, want):
        ctx.want = want
        return h if tuple(h.placements) == want else h.redistribute(h.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def mesh_scope():
    """The context a step on DTensor weights runs in, forward and backward:
    tensors the model makes itself (positions, RoPE tables, masks, the
    loss's vocab mask, SSM conv padding) enter each op as replicated
    DTensors.  It is ``torch.distributed.tensor.experimental.
    implicit_replication``, an experimental API of PyTorch.  Without a
    mesh, a null context."""
    import contextlib

    if _MESH[0] is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


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
    block (each such superblock recomputed in the backward pass under
    remat, as the JAX package checkpoints it); the trailing ``n_layers %
    attn_every`` blocks after the last.  With a cache, each layer's conv
    and SSM states and each application's KV are written into it."""
    cfg = model.cfg
    n_apps = _n_attn_apps(cfg)
    for app in range(n_apps):
        h = _remat(cfg, lambda hh, a=app: _superblock(model, hh, positions, a, cache), h)
    for i in range(n_apps * cfg.attn_every, cfg.n_layers):
        h = _constrain_tokens(_ssm_step(model.blocks[i], h, cache, i))
    return h


def _superblock(model: Transformer, h, positions, app: int, cache=None):
    """Zamba2's superblock ``app``: its ``attn_every`` mamba layers, then
    the shared block with that application's KV cache, if any."""
    per = model.cfg.attn_every
    for i in range(app * per, (app + 1) * per):
        h = _constrain_tokens(_ssm_step(model.blocks[i], h, cache, i))
    kv = None if cache is None else {
        "k": cache["k"][app], "v": cache["v"][app], "len": cache["len"]}
    return _constrain_tokens(_shared_attn(model, h, positions, app, kv_cache=kv)[0])


def _ssm_step(blk: Block, h, cache, i: int):
    """One mamba layer; with a cache, its layer ``i`` states are read and
    replaced in place."""
    if cache is None:
        return _ssm_layer(blk, h)[0]
    h, nc = _ssm_layer(blk, h, cache={"conv": cache["conv"][i], "S": cache["S"][i]})
    cache["conv"][i].copy_(nc["conv"])
    cache["S"][i].copy_(nc["S"])
    return h


def _remat(cfg: ArchConfig, fn, h: torch.Tensor) -> torch.Tensor:
    """``fn(h)``; where ``cfg.remat == 'full'`` and autograd records, under
    ``torch.utils.checkpoint`` (where the JAX package checkpoints the
    block): its activations are recomputed in the backward pass, which
    changes memory, not numerics."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, h, use_reentrant=False)
    return fn(h)


def _encode_audio(model: Transformer, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over frame embeddings [B, T_enc, D]: non-causal
    self-attention (the flash kernel on the card outside autograd) and the
    MLP per layer."""
    B, T_enc, _ = frames.shape
    pos = _positions(0, B, T_enc, frames.device)
    h = frames
    for blk in model.enc_blocks:
        h = _remat(model.cfg, lambda hh, b=blk: _constrain_tokens(
            _dense_block(b, hh, pos, causal=False)[0]), h)
    return model.enc_norm(h)


def _cross_kv(model: Transformer, enc: torch.Tensor, i: int):
    """Layer ``i``'s cross-attention K, V [B, T_enc, Hkv, d] of the
    encoder output."""
    cfg = model.cfg
    B, T_enc, _ = enc.shape
    p = model.cross_blocks[i].attn.params()
    H, dh = cfg.n_kv_heads, cfg.d_head
    return (L._split_heads(enc @ L.gather_weight(p["wk"]), B, T_enc, H, dh),
            L._split_heads(enc @ L.gather_weight(p["wv"]), B, T_enc, H, dh))


def _embed(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the embedding; a DTensor table whose vocab is
    sharded over ``model`` as ``embedding``, which DTensor looks up per
    shard and sums (a masked partial)."""
    table = L.gather_weight(model.embed)
    if not L._is_dtensor(table) or not any(p.is_shard(0) for p in table.placements):
        return table[tokens]
    return torch.nn.functional.embedding(tokens, table)


def _head(model: Transformer) -> torch.Tensor:
    """The LM head [D, V_padded]: ``lm_head``, or the tied embedding's
    transpose."""
    if model.lm_head is None:
        return model.embed.t()
    return L.gather_weight(model.lm_head)


def _positions(start: int, batch: int, seq: int, device, mrope: bool = False) -> torch.Tensor:
    pos = (start + torch.arange(seq, device=device)).expand(batch, seq)
    return pos.expand(3, batch, seq) if mrope else pos


def forward(model: Transformer, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token logits [B, S, V_padded] (training / prefill path, no caches).
    ``positions`` [B, S] ([3, B, S] for M-RoPE) default to 0..S-1 on every
    stream; the audio family needs ``frames`` [B, T_enc, D].  Under
    autograd with ``cfg.remat == 'full'`` each block (zamba2: each
    superblock; whisper: each encoder and decoder layer) is recomputed in
    the backward pass, where the JAX package checkpoints it."""
    cfg = model.cfg
    B, S = tokens.shape
    h = _constrain_tokens(_embed(model, tokens))  # gather
    if positions is None:
        positions = _positions(0, B, S, tokens.device, cfg.mrope)
    lib = published(cfg)
    if cfg.family in ("dense", "vlm", "moe"):
        for blk in model.blocks:
            h = _remat(cfg, lambda hh, b=blk: _constrain_tokens(
                _dense_block(b, hh, positions)[0]), h)
    elif cfg.family == "ssm":
        for blk in model.blocks:
            h = _remat(cfg, lambda hh, b=blk: _constrain_tokens(_ssm_layer(b, hh)[0]), h)
    elif lib is not None:
        h = lib.layers(model, h, positions)
    elif cfg.family == "hybrid":
        h = _hybrid_layers(model, h, positions)
    elif cfg.family == "audio":
        if frames is None:
            raise ValueError("audio family needs `frames` (stub embeddings)")
        enc = _encode_audio(model, frames)

        def layer(hh, i):
            cross = (model.cross_blocks[i], *_cross_kv(model, enc, i))
            return _constrain_tokens(
                _dense_block(model.blocks[i], hh, positions, cross=cross)[0])

        for i in range(cfg.n_layers):
            h = _remat(cfg, lambda hh, i=i: layer(hh, i), h)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _logits(model, h)


def _logits(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    """The head over the final norm of h, divided by ``cfg.logits_scaling``
    (the division applied to h, before the product: the same values for a
    power of two, as Granite 4.0-H's 16 is, without a second [.., V] pass)."""
    h = L.rmsnorm(h, model.final_norm.gamma, model.cfg.norm_eps)
    s = model.cfg.logits_scaling
    return (h if s == 1.0 else h / s) @ _head(model)


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
    lib = published(cfg)
    if lib is not None:
        return lib.init_cache(cfg, batch, max_len, device=device, dtype=dt)
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


def decode_step(model: Transformer, cache: dict, tokens: torch.Tensor,
                at: Optional[torch.Tensor] = None) -> tuple[dict, torch.Tensor]:
    """One decode step: tokens [B, S] -> (updated cache, logits [B, S, V]).

    S == 1 attends to the cache; S > 1 is the prefill of an empty cache,
    whose logits are taken at the positions ``at`` only where given
    ([B, len(at), V]).
    The cache's tensors are updated in place.  A published layout's
    decode step is its module's ``decode_static`` at position 'len', or at
    the device position 'pos' (int64 [1]) where the cache holds one: the
    step its ``DecodeGraph`` captures.
    """
    cfg = model.cfg
    B, S = tokens.shape
    idx = cache["len"]
    lib = published(cfg)
    if lib is not None and (idx or "pos" in cache):
        if S != 1:
            raise ValueError("a decode step after the prefill takes one token")
        at = cache.get("pos")
        if at is None:
            at = torch.tensor([idx], dtype=torch.long, device=tokens.device)
        return dict(cache, len=idx + 1), lib.decode_static(model, cache, tokens, at)
    h = _constrain_tokens(_embed(model, tokens))
    pos = _positions(idx, B, S, tokens.device, cfg.mrope)

    def kv(i):
        return {"k": cache["k"][i], "v": cache["v"][i], "len": idx}

    if cfg.family in ("dense", "vlm", "moe"):
        for i, blk in enumerate(model.blocks):
            h, _ = _dense_block(blk, h, pos, kv_cache=kv(i))
    elif cfg.family == "ssm":
        for i, blk in enumerate(model.blocks):
            h = _ssm_step(blk, h, cache, i)
    elif lib is not None:
        h = lib.layers(model, h, pos, cache=cache)
    elif cfg.family == "hybrid":
        h = _hybrid_layers(model, h, pos, cache=cache)
    elif cfg.family == "audio":
        for i, (blk, xblk) in enumerate(zip(model.blocks, model.cross_blocks)):
            h, _ = _dense_block(blk, h, pos, kv_cache=kv(i),
                                cross=(xblk, cache["xk"][i], cache["xv"][i]))
    else:
        raise ValueError(cfg.family)
    new_cache = dict(cache, len=idx + S)
    return new_cache, _logits(model, h if at is None else h.index_select(1, at))


def prefill(model: Transformer, tokens: torch.Tensor, max_len: int,
            frames: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None,
            at: Optional[torch.Tensor] = None) -> tuple[dict, torch.Tensor]:
    """Prefill a prompt and build decode caches: the decode path over the
    whole prompt at once (an S-token step), as the JAX package does; the
    audio family first encodes ``frames`` and caches each layer's cross
    K, V.  ``cache`` is an empty cache of ``init_cache``'s layout to fill
    (the dry run passes its sharded one); by default one is made.
    Returns (cache, logits [B, S, V_padded] at every prompt position, or
    [B, len(at), V_padded] at the positions ``at`` (int64 on the tokens'
    device) where given)."""
    B, _ = tokens.shape
    enc_len = frames.shape[1] if frames is not None else 0
    if cache is None:
        # the caches take the weights' type (float64 for a model cast with .double())
        cache = init_cache(model.cfg, B, max_len, device=tokens.device, enc_len=enc_len,
                           dtype=model.embed.dtype)
    if model.cfg.family == "audio":
        enc = _encode_audio(model, frames)
        for i in range(model.cfg.n_layers):
            xk, xv = _cross_kv(model, enc, i)
            cache["xk"][i].copy_(xk)
            cache["xv"][i].copy_(xv)
    return decode_step(model, cache, tokens, at=at)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _param_lists(model: Transformer) -> dict:
    """The JAX tree with, at each leaf of a stacked tree, the list of the
    layers' parameters; elsewhere the parameter itself."""
    def transpose(layers):
        if isinstance(layers[0], dict):
            return {k: transpose([blk[k] for blk in layers]) for k in layers[0]}
        return list(layers)

    return {k: transpose(v) if k in _STACKED else v
            for k, v in weights(model).items()}


class _StackedView:
    """The model bound to the JAX layout: ``params`` and ``grads`` are
    trees of tensors (one [L, ...] tensor per stacked leaf), every
    parameter's storage is its slice of ``params`` and its ``.grad`` its
    slice of ``grads``."""

    def __init__(self, model: Transformer):
        self.bound = []  # (parameter, its slice of params, its slice of grads)

        def bind(ps):
            layers = ps if isinstance(ps, list) else [ps]
            with torch.no_grad():
                p = torch.stack([q.detach() for q in layers])
            g = torch.zeros_like(p)
            for i, q in enumerate(layers):
                q.data = p[i]
                q.grad = g[i]
                self.bound.append((q, p[i], g[i]))
            return (p, g) if isinstance(ps, list) else (p[0], g[0])

        pairs = _tree_map(bind, _param_lists(model))
        self.params = _tree_map(lambda pg: pg[0], pairs)
        self.grads = _tree_map(lambda pg: pg[1], pairs)

    def holds(self) -> bool:
        """True while every parameter still lives in its slice (a ``.to()``
        or ``.double()`` of the model gives it new storage)."""
        return all(q.data_ptr() == p.data_ptr() and q.dtype == p.dtype
                   and q.device == p.device for q, p, _ in self.bound)

    def zero_grads(self) -> None:
        for _, _, g in self.bound:
            g.zero_()
        for q, _, g in self.bound:
            q.grad = g

    def collect_grads(self) -> dict:
        """The gradients of the last backward pass in ``grads`` (a backward
        pass accumulates into a bound ``.grad`` in place; a gradient it put
        elsewhere is copied in)."""
        for q, _, g in self.bound:
            if q.grad is not None and q.grad.data_ptr() != g.data_ptr():
                g.copy_(q.grad)
                q.grad = g
        return self.grads


def _view(model: Transformer) -> _StackedView:
    view = model.__dict__.get("_stacked_view")
    if view is None or not view.holds():
        view = _StackedView(model)
        model.__dict__["_stacked_view"] = view
    return view


def param_tree(model: Transformer) -> dict:
    """The model's weights as the JAX package's parameter tree: each leaf
    of a stacked tree (``blocks``, ``enc_blocks``, ``cross_blocks``) ONE
    tensor [L, ...] whose slices the layers' parameters are, every other
    leaf the parameter's own storage.  The first call moves the layers'
    parameters into the stacked tensors (values unchanged); later calls
    return the same tensors.  Writing a leaf in place writes the model.
    The optimizer updates this tree, so its per-leaf rules (AdamW's decay
    of ndim >= 2, Adafactor's factoring and RMS clip, the EF scale) see
    the stacked leaves the JAX package's rules see."""
    return _view(model).params


def assign_params(model: Transformer, new: dict) -> None:
    """Write a tree in the layout of ``param_tree`` into the model."""
    with torch.no_grad():
        _tree_map(lambda dst, src: dst.copy_(src), param_tree(model), new)


def loss_fn(model: Transformer, batch: dict) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (f32 softmax; float64 for a float64 model)
    plus z-loss, mean over tokens: ``(loss, {'nll', 'zloss'})``.  Padded
    vocab columns are masked out by subtracting 1e9; ``batch`` holds
    'tokens' and 'labels' [B, S] and, for the VLM and audio families,
    'positions' and 'frames'."""
    cfg = model.cfg
    logits = forward(model, batch["tokens"], positions=batch.get("positions"),
                     frames=batch.get("frames"))
    logits = logits.to(L._acc(logits.dtype))
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab_size
        logits = logits - pad.to(logits.dtype) * 1e9
    logz = _constrain_tokens(L.logsumexp_last(logits))
    # the label's logit: a gather, where the JAX package reduces an
    # iota-compare (the same value: one logit plus zeros)
    ll = _constrain_tokens(L.gather_last(logits, batch["labels"]))
    nll = (logz - ll).mean()
    zloss = 1e-4 * (logz**2).mean()
    return nll + zloss, {"nll": nll, "zloss": zloss}


def loss_and_grads(model: Transformer, batch: dict) -> tuple[tuple, dict]:
    """The JAX package's ``value_and_grad`` of ``loss_fn``: ((loss, metrics),
    grads), the gradients a tree in the layout of ``param_tree`` and the
    parameters' dtype.  The gradient tensors are buffers bound to the
    model, overwritten by the next call."""
    view = _view(model)
    view.zero_grads()
    with torch.enable_grad():
        loss, metrics = loss_fn(model, batch)
        loss.backward()
    grads = view.collect_grads()
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads


def train_step_fn(cfg: ArchConfig, optimizer):
    """A ``(model, opt_state, batch) -> (model, opt_state, metrics)`` step
    for this arch and optimizer (see ``distributed/optimizer.py``): the
    loss and its gradients, then the optimizer's update of
    ``param_tree(model)``, written into the model in place."""

    def step(model: Transformer, opt_state: dict, batch: dict):
        if model.cfg != cfg:
            raise ValueError(f"step built for {cfg.name}, model is {model.cfg.name}")
        (loss, metrics), grads = loss_and_grads(model, batch)
        new, opt_state = optimizer.update(param_tree(model), grads, opt_state)
        assign_params(model, new)
        return model, opt_state, dict(metrics, loss=loss)

    return step
