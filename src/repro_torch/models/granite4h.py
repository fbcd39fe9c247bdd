"""Granite 4.0-H as published (``GraniteMoeHybridConfig``; ``transformers``'
``GraniteMoeHybridForCausalLM``): the layer loop with its caches, the
port's random init and the loader from the published checkpoint's
parameter names.

The layer loop (``layers``), for x0 the token embeddings and h = x0 *
embedding_multiplier, every layer i:

* h = h + residual_multiplier * mixer_i(rmsnorm_i(h)), the mixer a Mamba2
  layer (``models/ssm.py``: one group, a conv with bias, softplus(dt) not
  clamped, the gated RMSNorm over d_inner in f32) or, at
  ``attn_layer_ids``, GQA attention with no position embedding and scores
  scaled by ``attention_multiplier`` (the flash kernel on the card);
* h = h + residual_multiplier * (moe_i(u) + shared_i(u)), u =
  rmsnorm'_i(h): the dropless MoE (``moe.moe_dropless``) and the shared
  SwiGLU expert;

then logits = rmsnorm(h) @ embed^T / logits_scaling (``transformer._logits``).

Weights live in the port's layout (``x @ w``, w [in, out]) in ``blocks``,
one a layer: norm1, norm2, ``ssm`` (as ``ssm.init_ssm_block``) or ``attn``
(wq [D, Hq dh], wk and wv [D, Hkv dh], wo [Hq dh, D]), ``moe`` (router
[D, E]; the experts in the published layout, w_in [E, 2F, D] with the gate
rows first and w_out [E, D, F]) and ``shared`` (w_in [D, 2 F_shared],
w_out [F_shared, D]).  The caches: conv and SSM states per mamba layer,
K and V [n_attn, B, max_len, Hkv, dh] per attention layer, and 'route'
[L, B, k] and 'moe' [L, B, D], the experts each decode step routed to and
each MoE block's output (written by the step, read by ``observe_decode``
and ``decode_taps``).  The decode step runs on the card as one CUDA
graph, ``zamba2.DecodeGraph`` over this cache (``decode_graph``).

Traced (``repro_torch.obs`` on): span ``lm.moe`` around each MoE block
outside the decode graph (attributes layer, phase, tokens; its device time
from a pair of CUDA events on the card), counters ``lm.moe_blocks``,
``lm.moe_assignments``, ``lm.moe_experts_hit`` (experts with at least one
assignment) and ``lm.moe_max_load`` (the largest expert's assignments),
each summed over the blocks; a decode step's are read from its routing
buffer after its tokens reach the host (``observe_decode``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import zamba2
from repro_torch.models.config import ArchConfig, GraniteMoeHybridConfig

# the decode step as one CUDA graph over this model's cache, as the
# published Zamba2's (``zamba2.DecodeGraph``)
decode_graph = zamba2.decode_graph


def config_from_hf(conf: dict, name: str = "granite4h",
                   dtype: str = "bfloat16") -> GraniteMoeHybridConfig:
    """The port's config of a published Granite 4.0-H ``config.json`` (its
    keys as ``transformers``' ``GraniteMoeHybridConfig`` names them).
    Raises for what the port does not run: a position embedding, biases,
    untied embeddings, another activation or layer kind, a conv other
    than ``ssm.CONV_K`` wide, more than one group of B and C."""
    unsupported = {
        "position_embedding_type": (conf.get("position_embedding_type"), "nope"),
        "attention_bias": (bool(conf.get("attention_bias", False)), False),
        "mamba_proj_bias": (bool(conf.get("mamba_proj_bias", False)), False),
        "tie_word_embeddings": (bool(conf.get("tie_word_embeddings", False)), True),
        "hidden_act": (conf.get("hidden_act"), "silu"),
        "mamba_d_conv": (conf.get("mamba_d_conv"), ssm_lib.CONV_K),
        # the gated norm spans the whole d_inner, the port's one group
        "mamba_n_groups": (conf.get("mamba_n_groups"), 1),
    }
    for key, (got, want) in unsupported.items():
        if got != want:
            raise ValueError(f"granite4h runs {key} {want!r}, not {got!r}")
    kinds = list(conf["layer_types"])
    if set(kinds) - {"mamba", "attention"} or len(kinds) != conf["num_hidden_layers"]:
        raise ValueError(f"layer_types must name 'mamba' or 'attention' a layer, got {kinds}")
    D, heads = conf["hidden_size"], conf["num_attention_heads"]
    return GraniteMoeHybridConfig(
        name=name, family="granite4h", n_layers=conf["num_hidden_layers"], d_model=D,
        n_heads=heads, n_kv_heads=conf["num_key_value_heads"], d_head=D // heads,
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        n_experts=conf["num_local_experts"], top_k=conf["num_experts_per_tok"],
        ssm_state=conf["mamba_d_state"], ssm_expand=conf["mamba_expand"],
        ssm_head_dim=conf["mamba_d_head"], ssm_chunk=conf["mamba_chunk_size"],
        attn_layer_ids=tuple(i for i, k in enumerate(kinds) if k == "attention"),
        shared_d_ff=conf["shared_intermediate_size"],
        embedding_multiplier=float(conf["embedding_multiplier"]),
        residual_multiplier=float(conf["residual_multiplier"]),
        attention_multiplier=float(conf["attention_multiplier"]),
        logits_scaling=float(conf["logits_scaling"]), conv_bias=bool(conf["mamba_conv_bias"]),
        norm_eps=float(conf["rms_norm_eps"]),
        max_position=conf["max_position_embeddings"],
        rope_theta=float(conf.get("rope_theta", 1e4)), dtype=dtype,
        vocab_pad_to=conf.get("vocab_pad_to", 256),
    )


def hf_config(cfg: GraniteMoeHybridConfig) -> dict:
    """The published config keys of a port config (``config_from_hf``'s
    inverse, for the keys it reads)."""
    return {
        "model_type": "granitemoehybrid", "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "intermediate_size": cfg.d_ff,
        "shared_intermediate_size": cfg.shared_d_ff, "vocab_size": cfg.vocab_size,
        "num_local_experts": cfg.n_experts, "num_experts_per_tok": cfg.top_k,
        "mamba_d_state": cfg.ssm_state, "mamba_expand": cfg.ssm_expand,
        "mamba_d_head": cfg.ssm_head_dim, "mamba_n_heads": cfg.ssm_heads,
        "mamba_n_groups": cfg.ssm_groups, "mamba_chunk_size": cfg.ssm_chunk,
        "mamba_d_conv": ssm_lib.CONV_K, "mamba_conv_bias": cfg.conv_bias,
        "mamba_proj_bias": False, "attention_bias": False,
        "layer_types": ["attention" if i in cfg.attn_layer_ids else "mamba"
                        for i in range(cfg.n_layers)],
        "embedding_multiplier": cfg.embedding_multiplier,
        "residual_multiplier": cfg.residual_multiplier,
        "attention_multiplier": cfg.attention_multiplier,
        "logits_scaling": cfg.logits_scaling, "rms_norm_eps": cfg.norm_eps,
        "max_position_embeddings": cfg.max_position, "rope_theta": cfg.rope_theta,
        "position_embedding_type": "nope", "hidden_act": "silu",
        "tie_word_embeddings": True, "normalization_function": "rmsnorm",
        "initializer_range": 0.02,
    }


# --------------------------------------------------------------------------
# init and loading
# --------------------------------------------------------------------------
def init_weights(generator: torch.Generator, cfg: ArchConfig, device) -> dict:
    """The port's own random weights, as ``Transformer`` takes them:
    projections N(0, 1/fan_in), experts N(0, 0.02^2) one expert at a time,
    norms 1, SSM gains as ``ssm.init_ssm_block``."""
    dt = L._dtype(cfg)
    D, F, Fs, E = cfg.d_model, cfg.d_ff, cfg.shared_d_ff, cfg.n_experts
    ones = lambda n: torch.ones((n,), dtype=dt, device=device)  # noqa: E731
    dense = lambda *shape: L.dense_init(generator, shape, dt, device=device)  # noqa: E731

    def experts(*shape):
        out = torch.empty((E, *shape), dtype=dt, device=device)
        for e in range(E):
            out[e] = torch.randn(shape, generator=generator, device=device).mul_(0.02)
        return out

    blocks = []
    for i in range(cfg.n_layers):
        blk = {"norm1": ones(D), "norm2": ones(D),
               "moe": {"router": dense(D, E), "w_in": experts(2 * F, D),
                       "w_out": experts(D, F)},
               "shared": {"w_in": dense(D, 2 * Fs), "w_out": dense(Fs, D)}}
        if i in cfg.attn_layer_ids:
            blk["attn"] = L.init_attention(generator, cfg, device=device)
        else:
            blk["ssm"] = ssm_lib.init_ssm_block(generator, cfg, device=device)
        blocks.append(blk)
    embed = torch.randn((cfg.vocab_padded, D), generator=generator, device=device)
    return {"embed": embed.mul_(0.02).to(dt), "final_norm": ones(D), "blocks": blocks}


def weights_from_hf(state, cfg: ArchConfig, device=None) -> dict:
    """A state dict under ``GraniteMoeHybridForCausalLM``'s names (any
    mapping; each name is read once, so one that draws a tensor when it is
    read never holds two copies) -> the weights ``Transformer`` takes, in
    ``cfg.dtype`` on ``device`` (the SSM gains in f32); linears transposed
    to the port's layout, the experts kept in the published one."""
    dt = L._dtype(cfg)

    def w(name, f32=False, t=False):
        x = state[name]
        x = x.t() if t else x
        return x.to(device=device, dtype=torch.float32 if f32 else dt, copy=True).contiguous()

    V = cfg.vocab_padded
    emb = w("model.embed_tokens.weight")
    if emb.shape[0] < V:
        emb = torch.cat([emb, emb.new_zeros((V - emb.shape[0], emb.shape[1]))])
    blocks = []
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        moe = pre + "block_sparse_moe."
        blk = {
            "norm1": w(pre + "input_layernorm.weight"),
            "norm2": w(pre + "post_attention_layernorm.weight"),
            "moe": {"router": w(moe + "router.layer.weight", t=True),
                    "w_in": w(moe + "input_linear.weight"),
                    "w_out": w(moe + "output_linear.weight")},
            "shared": {"w_in": w(pre + "shared_mlp.input_linear.weight", t=True),
                       "w_out": w(pre + "shared_mlp.output_linear.weight", t=True)},
        }
        if i in cfg.attn_layer_ids:
            a = pre + "self_attn."
            blk["attn"] = {k: w(a + f"{n}_proj.weight", t=True)
                           for k, n in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o"))}
        else:
            m = pre + "mamba."
            blk["ssm"] = {
                "in_proj": w(m + "in_proj.weight", t=True),
                "out_proj": w(m + "out_proj.weight", t=True),
                "conv_w": w(m + "conv1d.weight")[:, 0, :].t().contiguous(),
                "A_log": w(m + "A_log", f32=True),
                "D_skip": w(m + "D", f32=True),
                "dt_bias": w(m + "dt_bias", f32=True),
                "norm": w(m + "norm.weight"),
            }
            if cfg.conv_bias:
                blk["ssm"]["conv_b"] = w(m + "conv1d.bias")
        blocks.append(blk)
    return {"embed": emb, "final_norm": w("model.norm.weight"), "blocks": blocks}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _attention(blk, u: torch.Tensor, cfg: ArchConfig, kv: Optional[dict]) -> torch.Tensor:
    """GQA over u [B, S, D] with no position embedding, scores scaled by
    ``attention_multiplier``, through the KV cache ``kv`` where given
    (``layers.cached_attend``)."""
    B, S, _ = u.shape
    p = blk.attn.params()
    q = (u @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = (u @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = (u @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    if kv is not None:
        obs.count("lm.kv_bytes", 2 * k.numel() * k.element_size())
    o = L.cached_attend(q, k, v, cfg, cfg.attention_multiplier, kv)
    return o.reshape(B, S, cfg.n_heads * cfg.d_head) @ p["wo"]


def _mamba(blk, u: torch.Tensor, cfg: ArchConfig, cache: Optional[dict], m: int) -> torch.Tensor:
    """The mamba mixer of the ``m``-th mamba layer over u; with a cache,
    its states are read and replaced in place."""
    if cache is None:
        return ssm_lib.ssm_block_apply(blk.ssm.params(), u, cfg)[0]
    c = {"conv": cache["conv"][m], "S": cache["S"][m]}
    y, nc = ssm_lib.ssm_block_apply(blk.ssm.params(), u, cfg, cache=c)
    c["conv"].copy_(nc["conv"])
    c["S"].copy_(nc["S"])
    return y


def _moe(blk, u: torch.Tensor, cfg: ArchConfig, layer: int,
         route: Optional[torch.Tensor]) -> torch.Tensor:
    """Layer ``layer``'s routed experts over u [B, S, D]: a decode step
    (``route``, its slice of the cache's routing buffer, given) on the
    static form, which writes its ids there; anything else with the
    largest load as each expert's slots, whose loads it counts."""
    B, S, D = u.shape
    phase = "decode" if route is not None else "prefill"
    with obs.device_span("lm.moe", (layer, phase, B * S) if obs.ON else (), u.device):
        y, ids, loads = moe_lib.moe_dropless(u.reshape(B * S, D), blk.moe.params(),
                                             cfg.top_k, static=route is not None)
        if route is not None:
            route.copy_(ids.reshape(route.shape))
    if loads is not None and obs.ON:
        _count_loads(np.array([loads]), B * S * cfg.top_k)
    return y.reshape(B, S, D)


def _count_loads(loads: np.ndarray, assignments: int) -> None:
    """The MoE counters of blocks whose experts took ``loads`` [blocks, E]
    assignments, ``assignments`` a block.  In numpy: PyTorch's CPU
    operations wake their thread pool, whose wake-ups on a busy host
    stretched the decode steps that count here by milliseconds at random
    (steps of 38.2 +- 3.5 ms, against +- 0.2 ms in numpy, on an H100)."""
    obs.count("lm.moe_blocks", loads.shape[0])
    obs.count("lm.moe_assignments", assignments * loads.shape[0])
    obs.count("lm.moe_experts_hit", int((loads > 0).sum()))
    obs.count("lm.moe_max_load", int(loads.max(axis=1).sum()))


def _shared(blk, u: torch.Tensor) -> torch.Tensor:
    """The shared SwiGLU expert over u."""
    p = blk.shared.params()
    gate, up = (u @ p["w_in"]).chunk(2, dim=-1)
    return moe_lib._silu_glu(gate, up) @ p["w_out"]


def layers(model, x0: torch.Tensor, positions: torch.Tensor,
           cache: Optional[dict] = None, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The published layer loop over the embeddings x0 [B, S, D]
    (``positions`` unread: no layer has a position embedding); with a
    cache, the mamba layers' states and the attention layers' K and V are
    written into it.  ``pos`` (int64 [1] on the device, S == 1): a decode
    step at that position, the cache's 'len' unread (``decode_static``);
    its MoE blocks write their routing and their output into the cache's
    'route' and 'moe'.  Where ``serve`` asked for the rows of a request
    (``model.__dict__['_taps']`` = (rows, dict)), a prefill keeps those
    rows of each MoE block's output under 'moe'."""
    cfg = model.cfg
    attn_of = {lid: a for a, lid in enumerate(cfg.attn_layer_ids)}
    taps = model.__dict__.get("_taps") if pos is None else None
    if pos is not None:
        at = {"pos": pos, "kv_len": (pos + 1).to(torch.int32)}
    h = x0 * cfg.embedding_multiplier
    m = 0
    for i, blk in enumerate(model.blocks):
        u = L.rmsnorm(h, blk.norm1.gamma, cfg.norm_eps)
        a = attn_of.get(i)
        if a is None:
            y = _mamba(blk, u, cfg, cache, m)
            m += 1
        else:
            kv = None if cache is None else {
                "k": cache["k"][a], "v": cache["v"][a], "len": cache["len"]}
            if pos is not None:
                kv.update(at)
            y = _attention(blk, u, cfg, kv)
        h = h + y * cfg.residual_multiplier
        u = L.rmsnorm(h, blk.norm2.gamma, cfg.norm_eps)
        y = _moe(blk, u, cfg, i, None if pos is None else cache["route"][i])
        if taps is not None:
            taps[1].setdefault("moe", []).append(y.index_select(0, taps[0]))
        if pos is not None:
            cache["moe"][i].copy_(y[:, 0])
        h = h + (y + _shared(blk, u)) * cfg.residual_multiplier
    return h


def decode_static(model, cache: dict, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """A decode step with its position on the device: tokens [B, 1] at
    position ``pos`` (int64 [1]) -> logits [B, 1, V_padded], the caches
    updated in place and their 'len' unread; every shape and address fixed
    from step to step, so ``DecodeGraph`` captures it once."""
    from repro_torch.models import transformer as T

    B = tok.shape[0]
    h = layers(model, model.embed[tok], pos.expand(B, 1), cache, pos=pos)
    return T._logits(model, h)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device,
               dtype: torch.dtype) -> dict:
    """conv [n_mamba, B, K-1, d_inner + 2 G N] and S [n_mamba, B, H, N, dh]
    (f32, or float64 for a float64 model) per mamba layer; K, V [n_attn,
    B, max_len, Hkv, d_head] per attention layer; 'route' [L, B, top_k]
    int64 and 'moe' [L, B, D], a decode step's experts and MoE outputs per
    layer."""
    z = dict(dtype=dtype, device=device)
    G, N = cfg.ssm_groups, cfg.ssm_state
    kv = (cfg.n_attn, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {
        "conv": torch.zeros((cfg.n_mamba, batch, ssm_lib.CONV_K - 1,
                             cfg.d_inner + 2 * G * N), **z),
        "S": torch.zeros((cfg.n_mamba, batch, cfg.ssm_heads, N, cfg.ssm_head_dim),
                         dtype=L._acc(dtype), device=device),
        "k": torch.zeros(kv, **z), "v": torch.zeros(kv, **z),
        "route": torch.zeros((cfg.n_layers, batch, cfg.top_k), dtype=torch.long,
                             device=device),
        "moe": torch.zeros((cfg.n_layers, batch, cfg.d_model), **z),
        "len": 0,
    }


def decode_taps(cache: dict) -> dict:
    """What a decode step leaves for ``serve`` to keep of a request's rows:
    'moe_decode', each MoE block's output [L, B, D]."""
    return {"moe_decode": cache["moe"]}


def observe_decode(model, cache: dict) -> None:
    """The MoE counters of the decode step whose tokens just reached the
    host, from the routing it left in the cache (one small copy; called
    with tracing on, after the step's token copy)."""
    E = model.cfg.n_experts
    route = cache["route"].cpu().numpy()  # [L, B, k]
    L = route.shape[0]
    flat = (route.reshape(L, -1) + E * np.arange(L)[:, None]).ravel()
    _count_loads(np.bincount(flat, minlength=L * E).reshape(L, E),
                 route.shape[1] * route.shape[2])
