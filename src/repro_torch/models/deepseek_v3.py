"""DeepSeek-V3's block as published (``DeepseekV3Config``; ``transformers``'
``DeepseekV3ForCausalLM``, model type ``deepseek_v3``), without q_lora, as
Kanana-2-30B-A3B-Instruct runs it: the layer loop with its latent cache,
the port's random init and the loader from the published checkpoint's
parameter names.

The layer loop (``layers``), for h the token embeddings, every layer i:

* h = h + mla_i(rmsnorm_i(h)): latent attention (MLA).  q = u W_q, per
  head [q_nope (``qk_nope_dim``), q_pe (``qk_rope_dim``)]; [c, k_pe] =
  u W_kv_a, c = rmsnorm(c) (``kv_a_layernorm``, ``kv_lora_rank`` wide),
  k_pe one rope head every head shares; RoPE on q_pe and k_pe, the pairs
  (2i, 2i + 1) rotated by theta_i (``transformers``'
  ``apply_rotary_pos_emb_interleave`` permutes each rope head to halves
  first: the same q . k, the rope dims kept here in pair order); scores
  scaled by (qk_nope_dim + qk_rope_dim)^-1/2, causal; o W_o.
* h = h + ffn_i(rmsnorm'_i(h)): a SwiGLU of width ``d_ff`` in the first
  ``first_k_dense`` layers, after them the dropless MoE on the sigmoid
  router (``moe.route_sigmoid``; ``moe.experts_grouped`` at prefill,
  ``moe.experts_in_slots``' static form at decode) plus the shared
  experts, one SwiGLU of width ``shared_d_ff``;

then logits = rmsnorm(h) @ lm_head (untied; ``transformer._logits``).

MLA runs in two forms.  A prefill (and a forward) takes the expanded one:
per head k = [c W_k, k_pe] (192) and v = c W_v (128) from ``kv_b_proj``,
then the flash kernel's 192 / 128 instantiation on the card.  A decode
step takes the absorbed one over the latent cache: q_lat = q_nope W_k^T
per head (512), [q_lat, q_pe] (576) against each cached row [c, k_pe]
with c as the value (MQA: one latent head every query head reads), the
rows past the step's position masked, then W_v and W_o; plain PyTorch
inside the decode graph.  The cache holds c after its norm and k_pe after
RoPE, ``kv_lora_rank`` + ``qk_rope_dim`` values a position a layer, and
no per-head K or V.  A prefill with a cache runs a row at a time (rows
whole: the flash kernel's causal mask is top-left aligned).

Weights live in the port's layout (``x @ w``, w [in, out]) in ``blocks``,
one a layer: norm1, norm2, ``mla`` (wq [D, H 192], wkv_a [D, 576],
kv_norm [512], wk_b and wv_b [H, 128, 512] (``kv_b_proj``'s per-head
rows as published), wo [H 128, D]), and ``dense`` (w_in [D, 2 F], gate
columns first, w_out [F, D]) or ``moe`` (router [D, E], bias [E] f32, the
experts w_in [E, 2 F, D], gate rows first, and w_out [E, D, F]) with
``shared`` (w_in [D, 2 F_shared], w_out [F_shared, D]).  The cache:
'latent' [L, B, max_len, 576], and 'route' [L_moe, B, k] and 'moe'
[L_moe, B, D], each decode step's experts and MoE outputs (as Granite
4.0-H's).  The decode step runs on the card as one CUDA graph,
``zamba2.DecodeGraph`` over this cache (``decode_graph``).

Traced (``repro_torch.obs`` on): span ``lm.mla`` (layer, phase, tokens)
around each MLA block outside the decode graph, a device span; counters
``lm.mla_blocks``, ``lm.mla_pairs`` (causal query-key pairs a prefill's
heads score) and ``lm.mla_latent_bytes`` (latent rows written, 576
values of the cache's dtype each); the MoE's ``lm.moe`` span and
counters as Granite 4.0-H's (``granite4h._moe``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import granite4h
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import zamba2
from repro_torch.models.config import ArchConfig, DeepseekV3Config

# the decode step as one CUDA graph over this model's cache
decode_graph = zamba2.decode_graph
# a decode step's MoE counters, as Granite 4.0-H's
observe_decode = granite4h.observe_decode
# the latent cache's rows are a multiple of this: a decode step's scores
# [B, H, R] and probabilities are then aligned operands of its products
# (at R 32,769 cuBLAS fell back to a slow unaligned kernel on an H100)
ROW_ALIGN = 64


def config_from_hf(conf: dict, name: str = "deepseek_v3",
                   dtype: str = "bfloat16") -> DeepseekV3Config:
    """The port's config of a published DeepSeek-V3 ``config.json`` (its
    keys as ``transformers``' ``DeepseekV3Config`` names them).  Raises for
    what the port does not run: q_lora, biases, rope scaling, RoPE on
    halves, another router (groups, softmax scoring, no normalisation),
    MoE layers not every layer after the dense ones, tied embeddings."""
    unsupported = {
        "q_lora_rank": (conf.get("q_lora_rank"), None),
        "attention_bias": (bool(conf.get("attention_bias", False)), False),
        "rope_scaling": (conf.get("rope_scaling"), None),
        "rope_interleave": (bool(conf.get("rope_interleave", True)), True),
        "hidden_act": (conf.get("hidden_act"), "silu"),
        "scoring_func": (conf.get("scoring_func", "sigmoid"), "sigmoid"),
        "topk_method": (conf.get("topk_method", "noaux_tc"), "noaux_tc"),
        "norm_topk_prob": (bool(conf.get("norm_topk_prob", True)), True),
        "n_group": (conf.get("n_group", 1), 1),
        "topk_group": (conf.get("topk_group", 1), 1),
        "moe_layer_freq": (conf.get("moe_layer_freq", 1), 1),
        "tie_word_embeddings": (bool(conf.get("tie_word_embeddings", False)), False),
    }
    for key, (got, want) in unsupported.items():
        if got != want:
            raise ValueError(f"deepseek_v3 runs {key} {want!r}, not {got!r}")
    heads = conf["num_attention_heads"]
    if conf.get("num_key_value_heads", heads) != heads:
        raise ValueError("MLA's expanded form has a K and V head a query head")
    return DeepseekV3Config(
        name=name, family="deepseek_v3", n_layers=conf["num_hidden_layers"],
        d_model=conf["hidden_size"], n_heads=heads, n_kv_heads=heads,
        d_head=conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"],
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        n_experts=conf["n_routed_experts"], top_k=conf["num_experts_per_tok"],
        kv_lora_rank=conf["kv_lora_rank"], qk_nope_dim=conf["qk_nope_head_dim"],
        qk_rope_dim=conf["qk_rope_head_dim"], v_head_dim=conf["v_head_dim"],
        first_k_dense=conf["first_k_dense_replace"], moe_d_ff=conf["moe_intermediate_size"],
        n_shared_experts=conf["n_shared_experts"],
        routed_scaling=float(conf["routed_scaling_factor"]),
        norm_eps=float(conf["rms_norm_eps"]), max_position=conf["max_position_embeddings"],
        rope_theta=float(conf["rope_theta"]), dtype=dtype,
        vocab_pad_to=conf.get("vocab_pad_to", 256),
    )


def hf_config(cfg: DeepseekV3Config) -> dict:
    """The published config keys of a port config (``config_from_hf``'s
    inverse, for the keys it reads)."""
    return {
        "model_type": "deepseek_v3", "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_heads, "intermediate_size": cfg.d_ff,
        "moe_intermediate_size": cfg.moe_d_ff, "vocab_size": cfg.vocab_size,
        "n_routed_experts": cfg.n_experts, "num_experts_per_tok": cfg.top_k,
        "n_shared_experts": cfg.n_shared_experts, "first_k_dense_replace": cfg.first_k_dense,
        "kv_lora_rank": cfg.kv_lora_rank, "q_lora_rank": None,
        "qk_nope_head_dim": cfg.qk_nope_dim, "qk_rope_head_dim": cfg.qk_rope_dim,
        "qk_head_dim": cfg.qk_head_dim, "head_dim": cfg.qk_rope_dim,
        "v_head_dim": cfg.v_head_dim, "routed_scaling_factor": cfg.routed_scaling,
        "scoring_func": "sigmoid", "topk_method": "noaux_tc", "norm_topk_prob": True,
        "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
        "rope_theta": cfg.rope_theta, "rope_scaling": None, "rope_interleave": True,
        "rms_norm_eps": cfg.norm_eps, "max_position_embeddings": cfg.max_position,
        "hidden_act": "silu", "attention_bias": False, "tie_word_embeddings": False,
        "initializer_range": 0.02,
    }


# --------------------------------------------------------------------------
# init and loading
# --------------------------------------------------------------------------
def init_weights(generator: torch.Generator, cfg: ArchConfig, device) -> dict:
    """The port's own random weights, as ``Transformer`` takes them:
    projections N(0, 1/fan_in), experts and embeddings N(0, 0.02^2), the
    experts one at a time, norms 1, the router's bias N(0, 0.05^2) (a
    trained model's is not zero)."""
    dt = L._dtype(cfg)
    D, H, E, r = cfg.d_model, cfg.n_heads, cfg.n_experts, cfg.kv_lora_rank
    ones = lambda n: torch.ones((n,), dtype=dt, device=device)  # noqa: E731
    dense = lambda *shape: L.dense_init(generator, shape, dt, device=device)  # noqa: E731

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device).mul_(0.02).to(dt)

    def experts(*shape):
        out = torch.empty((E, *shape), dtype=dt, device=device)
        for e in range(E):
            out[e] = normal(*shape)
        return out

    blocks = []
    for i in range(cfg.n_layers):
        blk = {"norm1": ones(D), "norm2": ones(D),
               "mla": {"wq": dense(D, H * cfg.qk_head_dim), "wkv_a": dense(D, cfg.latent_dim),
                       "kv_norm": ones(r), "wk_b": normal(H, cfg.qk_nope_dim, r),
                       "wv_b": normal(H, cfg.v_head_dim, r),
                       "wo": dense(H * cfg.v_head_dim, D)}}
        if i < cfg.first_k_dense:
            blk["dense"] = {"w_in": dense(D, 2 * cfg.d_ff), "w_out": dense(cfg.d_ff, D)}
        else:
            bias = torch.randn((E,), generator=generator, device=device).mul_(0.05)
            blk["moe"] = {"router": dense(D, E), "bias": bias.to(L._acc(dt)),
                          "w_in": experts(2 * cfg.moe_d_ff, D),
                          "w_out": experts(D, cfg.moe_d_ff)}
            blk["shared"] = {"w_in": dense(D, 2 * cfg.shared_d_ff),
                             "w_out": dense(cfg.shared_d_ff, D)}
        blocks.append(blk)
    V = cfg.vocab_padded
    return {"embed": normal(V, D), "lm_head": dense(D, V), "final_norm": ones(D),
            "blocks": blocks}


def weights_from_hf(state, cfg: ArchConfig, device=None) -> dict:
    """A state dict under ``DeepseekV3ForCausalLM``'s names (any mapping;
    each name is read once, so one that draws a tensor when it is read
    never holds two copies) -> the weights ``Transformer`` takes, in
    ``cfg.dtype`` on ``device`` (the router's bias in f32): linears
    transposed to the port's layout, ``kv_b_proj`` split into its per-head
    K and V rows, each routed expert's gate and up stacked as w_in and its
    down as w_out."""
    dt = L._dtype(cfg)
    H, r, E, F = cfg.n_heads, cfg.kv_lora_rank, cfg.n_experts, cfg.moe_d_ff

    def w(name, f32=False, t=False):
        x = state[name]
        x = x.t() if t else x
        return x.to(device=device, dtype=L._acc(dt) if f32 else dt, copy=True).contiguous()

    def swiglu(pre):
        gate, up = w(pre + "gate_proj.weight", t=True), w(pre + "up_proj.weight", t=True)
        w_in = torch.cat([gate, up], dim=1)
        del gate, up
        return {"w_in": w_in, "w_out": w(pre + "down_proj.weight", t=True)}

    V = cfg.vocab_padded

    def padded(x, dim):  # the vocab's rows (or columns) up to V
        n = V - x.shape[dim]
        if not n:
            return x
        shape = list(x.shape)
        shape[dim] = n
        return torch.cat([x, x.new_zeros(shape)], dim=dim)

    blocks = []
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        a = pre + "self_attn."
        kvb = w(a + "kv_b_proj.weight").view(H, cfg.qk_nope_dim + cfg.v_head_dim, r)
        blk = {
            "norm1": w(pre + "input_layernorm.weight"),
            "norm2": w(pre + "post_attention_layernorm.weight"),
            "mla": {"wq": w(a + "q_proj.weight", t=True),
                    "wkv_a": w(a + "kv_a_proj_with_mqa.weight", t=True),
                    "kv_norm": w(a + "kv_a_layernorm.weight"),
                    "wk_b": kvb[:, : cfg.qk_nope_dim].contiguous(),
                    "wv_b": kvb[:, cfg.qk_nope_dim:].contiguous(),
                    "wo": w(a + "o_proj.weight", t=True)},
        }
        del kvb
        m = pre + "mlp."
        if i < cfg.first_k_dense:
            blk["dense"] = swiglu(m)
        else:
            w_in = torch.empty((E, 2 * F, cfg.d_model), dtype=dt, device=device)
            w_out = torch.empty((E, cfg.d_model, F), dtype=dt, device=device)
            for e in range(E):
                x = m + f"experts.{e}."
                w_in[e, :F] = state[x + "gate_proj.weight"]
                w_in[e, F:] = state[x + "up_proj.weight"]
                w_out[e] = state[x + "down_proj.weight"]
            blk["moe"] = {"router": w(m + "gate.weight", t=True),
                          "bias": w(m + "gate.e_score_correction_bias", f32=True),
                          "w_in": w_in, "w_out": w_out}
            blk["shared"] = swiglu(m + "shared_experts.")
        blocks.append(blk)
    return {"embed": padded(w("model.embed_tokens.weight"), 0),
            "lm_head": padded(w("lm_head.weight", t=True), 1),
            "final_norm": w("model.norm.weight"), "blocks": blocks}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def apply_rope_pairs(x: torch.Tensor, tables: tuple) -> torch.Tensor:
    """RoPE with the pairs (x[2i], x[2i + 1]) rotated by theta_i, on the
    tables of ``layers.rope_half_tables`` (cos and sin [B, S, 1, d/2]);
    rotated in their type and cast back."""
    cos, sin = tables
    x1, x2 = x[..., 0::2].to(cos.dtype), x[..., 1::2].to(cos.dtype)
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).flatten(-2).to(x.dtype)


def softmax_scale(cfg: ArchConfig) -> float:
    """(qk_nope_dim + qk_rope_dim)^-1/2, the f32 nearest (as the flash
    kernel and its plain version take it)."""
    return L._f32_scalar(cfg.qk_head_dim ** -0.5)


def _latent(p: dict, u: torch.Tensor, cfg: ArchConfig, rope: tuple) -> tuple:
    """The latent rows of u [B, S, D]: (c [B, S, r] after its norm, k_pe
    [B, S, 1, dr] after RoPE)."""
    r = cfg.kv_lora_rank
    kva = u @ p["wkv_a"]
    c = L.rmsnorm(kva[..., :r], p["kv_norm"], cfg.norm_eps)
    return c, apply_rope_pairs(kva[..., None, r:], rope)


def _write_latent(lat: torch.Tensor, row: torch.Tensor, pos: Optional[torch.Tensor]) -> None:
    """The step's latent rows into the layer's cache [B, R, 576]: a
    prefill's at 0..S-1, a decode step's at its device position."""
    if pos is not None:
        lat.index_copy_(1, pos, row)
    else:
        lat[:, : row.shape[1]] = row
    obs.count("lm.mla_latent_bytes", row.numel() * row.element_size())


def _mla(blk, u: torch.Tensor, cfg: ArchConfig, rope: tuple, layer: int,
         lat: Optional[torch.Tensor], pos: Optional[torch.Tensor]) -> torch.Tensor:
    """Layer ``layer``'s MLA over u [B, S, D].  ``lat`` (the layer's latent
    cache [B, R, 576]) takes the step's rows: a prefill's 0..S-1, then the
    expanded form over the prompt; a decode step (``pos``, int64 [1] on the
    device, S == 1) its row ``pos``, then the absorbed form over rows
    0..pos."""
    B, S, _ = u.shape
    H, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    p = blk.mla.params()
    scale = softmax_scale(cfg)
    phase = "decode" if pos is not None else "prefill"
    with obs.device_span("lm.mla", (layer, phase, B * S) if obs.ON else (), u.device):
        q = (u @ p["wq"]).view(B, S, H, dn + dr)
        q[..., dn:] = apply_rope_pairs(q[..., dn:], rope)
        c, k_pe = _latent(p, u, cfg, rope)
        if lat is not None:
            _write_latent(lat, torch.cat([c, k_pe[:, :, 0]], dim=-1), pos)
        obs.count("lm.mla_blocks")
        if pos is None:  # expanded: per-head K and V from the latent
            k = torch.empty((B, S, H, dn + dr), dtype=u.dtype, device=u.device)
            k[..., :dn] = (c @ p["wk_b"].view(H * dn, r).t()).view(B, S, H, dn)
            k[..., dn:] = k_pe
            v = (c @ p["wv_b"].view(H * dv, r).t()).view(B, S, H, dv)
            del c
            obs.count("lm.mla_pairs", B * H * S * (S + 1) // 2)
            o = L._attend(q, k, v, True, cfg, scale=scale)
            del q, k, v
            o = o.reshape(B, S, H * dv)
        else:  # absorbed: MQA of [q_nope W_k^T, q_pe] over the cached [c, k_pe]
            q_lat = torch.bmm(q[:, 0, :, :dn].transpose(0, 1), p["wk_b"])  # [H, B, r]
            qf = torch.cat([q_lat.transpose(0, 1), q[:, 0, :, dn:]], dim=-1)  # [B, H, 576]
            s = torch.bmm(qf, lat.transpose(1, 2)).to(L._acc(u.dtype)) * scale  # [B, H, R]
            future = torch.arange(lat.shape[1], device=u.device) > pos
            prob = torch.softmax(s.masked_fill_(future, -float("inf")), dim=-1)
            o_lat = torch.bmm(prob.to(u.dtype), lat[..., :r])  # [B, H, r]
            o = torch.bmm(o_lat.transpose(0, 1), p["wv_b"].transpose(1, 2))  # [H, B, dv]
            o = o.transpose(0, 1).reshape(B, 1, H * dv)
        return o @ p["wo"]


def _swiglu(params: dict, u: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up from w_in [D, 2 F] (gate columns first), then
    w_out [F, D]."""
    gate, up = (u @ params["w_in"]).chunk(2, dim=-1)
    return moe_lib._silu_glu(gate, up) @ params["w_out"]


def _shared(blk, u: torch.Tensor) -> torch.Tensor:
    """A MoE layer's shared experts over u, one SwiGLU."""
    return _swiglu(blk.shared.params(), u)


def _moe(blk, u: torch.Tensor, cfg: ArchConfig, layer: int,
         route: Optional[torch.Tensor]) -> tuple:
    """Layer ``layer``'s routed experts over u [B, S, D] on the sigmoid
    router -> (their output [B, S, D], the chosen experts [B, S, k]): a
    decode step (``route``, its slice of the cache's routing buffer,
    given) on ``experts_in_slots``' static form (a slot a token: every
    shape fixed), its ids written there; anything else on
    ``moe.experts_grouped``, each expert over its own rows (with tracing
    on, its loads read on the host and counted: ``granite4h._moe``'s spans
    and counters).
    The slots of ``moe_dropless``' prefill form (every expert padded to the
    largest load) are mostly padding here: under the published init one
    expert takes ~32% of a 32,704-token row (10,480 of 196,224 assignments
    on an H100), so its slots would be ~7x the assignments and ~14 GB, and
    their cost would follow each seed's skew."""
    B, S, D = u.shape
    p = blk.moe.params()
    phase = "decode" if route is not None else "prefill"
    x = u.reshape(B * S, D)
    loads = None
    with obs.device_span("lm.moe", (layer, phase, B * S) if obs.ON else (), u.device):
        gates, ids, _ = moe_lib.route_sigmoid(x, p["router"], p["bias"], cfg.top_k,
                                              cfg.routed_scaling)
        if route is not None:
            y = moe_lib.experts_in_slots(x, p, gates, ids, x.shape[0])
            route.copy_(ids.reshape(route.shape))
        else:
            y = moe_lib.experts_grouped(x, p, gates, ids)
            loads = moe_lib.expert_loads(ids, cfg.n_experts).tolist() if obs.ON else None
    if loads is not None:
        granite4h._count_loads(np.array([loads]), B * S * cfg.top_k)
    return y.reshape(B, S, D), ids.reshape(B, S, -1)


def _gates(blk, u: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The router's gates of u [.., D] scattered over the experts [.., E]
    (0 where an expert is not chosen), in f32: what a tap keeps of the
    first MoE block's routing (recomputed on the tapped tokens)."""
    p = blk.moe.params()
    x = u.reshape(-1, u.shape[-1])
    g, ids, scores = moe_lib.route_sigmoid(x, p["router"], p["bias"], cfg.top_k,
                                           cfg.routed_scaling)
    return torch.zeros_like(scores).scatter_(1, ids, g).reshape(*u.shape[:-1], -1)


def _layers(model, x0: torch.Tensor, positions: torch.Tensor, cache: Optional[dict],
            pos: Optional[torch.Tensor], keep: Optional[list]) -> tuple:
    """The layer loop over x0 [B, S, D] -> (h, taps): ``layers``' body for
    one call; ``keep`` ([rows, positions or None]) names the rows (and
    prompt positions) whose taps to return: 'moe', each MoE block's output
    [len(rows), positions, D], 'gates', the first MoE block's gates over
    the experts [len(rows), positions, E], and 'route', each MoE block's
    chosen experts at every position [len(rows), S, k] (int16)."""
    cfg = model.cfg
    rope = L.rope_half_tables(positions, cfg.qk_rope_dim, cfg.rope_theta, x0.dtype)
    taps = {"moe": [], "gates": [], "route": []} if keep is not None else None

    def tap(t):
        t = t.index_select(0, keep[0])
        return t if keep[1] is None else t.index_select(1, keep[1])

    h = x0
    for i, blk in enumerate(model.blocks):
        u = L.rmsnorm(h, blk.norm1.gamma, cfg.norm_eps)
        lat = None if cache is None else cache["latent"][i]
        h = h + _mla(blk, u, cfg, rope, i, lat, pos)
        u = L.rmsnorm(h, blk.norm2.gamma, cfg.norm_eps)
        if i < cfg.first_k_dense:
            h = h + _swiglu(blk.dense.params(), u)
            continue
        m = i - cfg.first_k_dense
        y, ids = _moe(blk, u, cfg, i, None if pos is None else cache["route"][m])
        if taps is not None:
            taps["moe"].append(tap(y))
            taps["route"].append(ids.index_select(0, keep[0]).to(torch.int16))
            if m == 0:
                taps["gates"].append(_gates(blk, tap(u), cfg))
        if pos is not None:
            cache["moe"][m].copy_(y[:, 0])
        h = h + (y + _shared(blk, u))
    return h, taps


def layers(model, x0: torch.Tensor, positions: torch.Tensor,
           cache: Optional[dict] = None, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The published layer loop over the embeddings x0 [B, S, D] at
    ``positions`` [B, S]; with a cache, every layer's latent rows are
    written into it.  A prefill with a cache runs a row at a time.
    ``pos`` (int64 [1] on the device, S == 1): a decode step at that
    position, the cache's 'len' unread (``decode_static``); its MoE blocks
    write their routing and their output into the cache's 'route' and
    'moe'.  Where ``serve`` asked for the rows of a request
    (``model.__dict__['_taps']`` = (rows, dict, prompt positions or
    None)), a prefill keeps those rows (at those positions) of each MoE
    block's output under 'moe' and of the first MoE block's gates under
    'gates', and each MoE block's chosen experts at every position under
    'route'."""
    taps = model.__dict__.get("_taps") if pos is None else None
    B = x0.shape[0]
    at = taps[2] if taps is not None and len(taps) > 2 else None
    if pos is not None or cache is None or B == 1:
        h, t = _layers(model, x0, positions, cache, pos,
                       None if taps is None else [taps[0], at])
        if t is not None:
            taps[1].update(t)
        return h
    rows = [] if taps is None else taps[0].tolist()
    h = torch.empty_like(x0)
    kept = {}
    for b in range(B):
        one = {"latent": cache["latent"][:, b: b + 1]}
        keep = [torch.zeros(1, dtype=torch.long, device=x0.device), at] if b in rows else None
        h[b: b + 1], kept[b] = _layers(model, x0[b: b + 1], positions[b: b + 1], one, None,
                                       keep)
    if taps is not None:
        for name in ("moe", "gates", "route"):
            taps[1][name] = [torch.cat([kept[b][name][m] for b in rows])
                             for m in range(len(kept[rows[0]][name]))]
    return h


def decode_static(model, cache: dict, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """A decode step with its position on the device: tokens [B, 1] at
    position ``pos`` (int64 [1]) -> logits [B, 1, V_padded], the cache
    updated in place and its 'len' unread; every shape and address fixed
    from step to step, so ``DecodeGraph`` captures it once."""
    from repro_torch.models import transformer as T

    B = tok.shape[0]
    h = layers(model, model.embed[tok], pos.expand(B, 1), cache, pos=pos)
    return T._logits(model, h)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device,
               dtype: torch.dtype) -> dict:
    """'latent' [L, B, R, kv_lora_rank + qk_rope_dim] (c after its norm,
    then k_pe after RoPE, a position), R ``max_len`` rounded up to
    ``ROW_ALIGN`` rows (the decode's products over the rows then take
    aligned operands); 'route' [L_moe, B, top_k]
    int64 and 'moe' [L_moe, B, D], a decode step's experts and MoE outputs
    per MoE layer."""
    z = dict(dtype=dtype, device=device)
    rows = -(-max_len // ROW_ALIGN) * ROW_ALIGN
    return {
        "latent": torch.zeros((cfg.n_layers, batch, rows, cfg.latent_dim), **z),
        "route": torch.zeros((cfg.n_moe, batch, cfg.top_k), dtype=torch.long,
                             device=device),
        "moe": torch.zeros((cfg.n_moe, batch, cfg.d_model), **z),
        "len": 0,
    }


def decode_taps(cache: dict) -> dict:
    """What a decode step leaves for ``serve`` to keep of a request's rows:
    'moe_decode', each MoE block's output [L_moe, B, D], and
    'route_decode', each MoE block's chosen experts [L_moe, B, k]."""
    return {"moe_decode": cache["moe"], "route_decode": cache["route"]}


def kept_cache(cache: dict, rows: torch.Tensor, positions: Optional[torch.Tensor]) -> dict:
    """What ``serve`` keeps of a request's rows of the final cache: every
    tensor's ``rows`` (on its axis 1), the latent cache's at ``positions``
    only where given (a 32k-position prompt's whole latent is 3.6 GB for
    two rows)."""
    out = {k: v.index_select(1, rows) for k, v in cache.items()
           if torch.is_tensor(v) and k != "latent"}
    lat = cache["latent"]
    if positions is not None:
        lat = lat.index_select(2, positions)
    out["latent"] = lat.index_select(1, rows)
    return out
