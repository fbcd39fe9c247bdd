"""Zamba2 as published (``Zamba2Config``; ``transformers``'
``Zamba2ForCausalLM``, arXiv:2411.15242): the shared blocks, the layer
loop with its caches, the port's random init and the loader from the
published checkpoint's parameter names.

The layer loop (``layers``), for x0 the token embeddings and h = x0:

* a mamba layer i: h = h + mamba_i(rmsnorm_i(h));
* a hybrid layer i, application a (its index in ``hybrid_layer_ids``):
  t = shared_{a % num_mem_blocks}(h, x0, a) @ linear_a, then
  h = h + mamba_i(rmsnorm_i(h + t)): t reaches the mamba layer's input,
  not its residual.

A shared block at application a: u = rmsnorm(concat[h, x0]) (width 2D);
attention over u (MHA, head dim ``d_head``, scores scaled by
(d_head / 2)^-1/2, RoPE over the whole head with its halves rotated), out
[.., D]; then rmsnorm and the gated-GELU MLP whose gate_up adds
application a's adapter (x @ A_a) @ B_a.  No residual inside the block.

Weights live in the port's layout (``x @ w``, w [in, out]): ``blocks``
(every layer's norm1 and ssm), ``shared_blocks`` (norm1 [2D], attn wq / wk
/ wv [2D, H dh] and wo [H dh, D], norm2 [D], mlp w_gate_up [D, 2F] and
w_down [F, D]) and ``apps`` (per application: linear [D, D], adapter_a
[D, r], adapter_b [r, 2F]); the LM head is the embedding, tied.  The
caches: per layer conv and SSM states, per application K and V
[n_apps, B, max_len, H, dh].
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig, Zamba2Config


def config_from_hf(conf: dict, name: str = "zamba2", dtype: str = "bfloat16") -> Zamba2Config:
    """The port's config of a published Zamba2 ``config.json`` (its keys as
    ``transformers``' ``Zamba2Config`` names them)."""
    D, heads = conf["hidden_size"], conf["num_attention_heads"]
    return Zamba2Config(
        name=name, family="zamba2", n_layers=conf["num_hidden_layers"], d_model=D,
        n_heads=heads, n_kv_heads=conf.get("num_key_value_heads") or heads,
        d_head=2 * D // heads, d_ff=conf["intermediate_size"],
        vocab_size=conf["vocab_size"], ssm_state=conf["mamba_d_state"],
        ssm_expand=conf["mamba_expand"],
        ssm_head_dim=conf["mamba_expand"] * D // conf["n_mamba_heads"],
        ssm_chunk=conf["chunk_size"], rope_theta=float(conf["rope_theta"]),
        hybrid_layer_ids=tuple(conf["hybrid_layer_ids"]),
        num_mem_blocks=conf["num_mem_blocks"], adapter_rank=conf["adapter_rank"],
        ssm_groups=conf["mamba_ngroups"], conv_bias=bool(conf["use_conv_bias"]),
        mlp_act=conf["hidden_act"], norm_eps=float(conf["rms_norm_eps"]),
        dt_min=float(conf["time_step_min"]), time_step_max=float(conf["time_step_max"]),
        time_step_floor=float(conf["time_step_floor"]),
        max_position=conf["max_position_embeddings"], tie_embeddings=True,
        dtype=dtype, vocab_pad_to=conf.get("vocab_pad_to", 256),
    )


def hf_config(cfg: Zamba2Config) -> dict:
    """The published config keys of a port config (``config_from_hf``'s
    inverse, for the keys it reads)."""
    return {
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
        "mamba_d_state": cfg.ssm_state, "mamba_expand": cfg.ssm_expand,
        "mamba_d_conv": ssm_lib.CONV_K, "n_mamba_heads": cfg.ssm_heads,
        "mamba_ngroups": cfg.ssm_groups, "chunk_size": cfg.ssm_chunk,
        "rope_theta": cfg.rope_theta, "hybrid_layer_ids": list(cfg.hybrid_layer_ids),
        "layers_block_type": ["hybrid" if i in cfg.hybrid_layer_ids else "mamba"
                              for i in range(cfg.n_layers)],
        "num_mem_blocks": cfg.num_mem_blocks, "adapter_rank": cfg.adapter_rank,
        "use_conv_bias": cfg.conv_bias, "hidden_act": cfg.mlp_act,
        "rms_norm_eps": cfg.norm_eps, "time_step_min": cfg.dt_min,
        "time_step_max": cfg.time_step_max, "time_step_floor": cfg.time_step_floor,
        "max_position_embeddings": cfg.max_position, "initializer_range": 0.02,
        "pad_token_id": 0, "use_mem_rope": True, "use_shared_attention_adapter": False,
        "use_long_context": False, "add_bias_linear": False,
    }


# --------------------------------------------------------------------------
# init and loading
# --------------------------------------------------------------------------
def init_weights(generator: torch.Generator, cfg: ArchConfig, device) -> dict:
    """The port's own random weights (projections N(0, 1/fan_in), adapters'
    B zeros, norms 1, SSM gains as ``ssm.init_ssm_block``), as
    ``Transformer`` takes them."""
    dt = L._dtype(cfg)
    D, F, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    Hd = cfg.n_heads * cfg.d_head
    ones = lambda n: torch.ones((n,), dtype=dt, device=device)  # noqa: E731
    dense = lambda *shape: L.dense_init(generator, shape, dt, device=device)  # noqa: E731
    weights = {
        "embed": (torch.randn((cfg.vocab_padded, D), generator=generator, device=device)
                  * 0.02).to(dt),
        "final_norm": ones(D),
        "blocks": [{"norm1": ones(D),
                    "ssm": ssm_lib.init_ssm_block(generator, cfg, device=device)}
                   for _ in range(cfg.n_layers)],
        "shared_blocks": [{
            "norm1": ones(2 * D), "norm2": ones(D),
            "attn": {"wq": dense(2 * D, Hd), "wk": dense(2 * D, Hd),
                     "wv": dense(2 * D, Hd), "wo": dense(Hd, D)},
            "mlp": {"w_gate_up": dense(D, 2 * F), "w_down": dense(F, D)},
        } for _ in range(cfg.num_mem_blocks)],
        "apps": [{"linear": dense(D, D), "adapter_a": dense(D, r),
                  "adapter_b": torch.zeros((r, 2 * F), dtype=dt, device=device)}
                 for _ in range(cfg.n_apps)],
    }
    return weights


def weights_from_hf(state: dict, cfg: ArchConfig, device=None) -> dict:
    """A state dict under ``Zamba2ForCausalLM``'s names -> the weights
    ``Transformer`` takes, in ``cfg.dtype`` on ``device`` (copies; the SSM
    gains in f32).  Each shared block's weights are read at the first
    hybrid layer that uses it; application a's adapter lives in block
    a % num_mem_blocks's ``gate_up_proj_adapter_list.a``."""
    dt = L._dtype(cfg)

    def w(name, f32=False, t=False):
        x = state[name]
        x = x.t() if t else x
        return x.to(device=device, dtype=torch.float32 if f32 else dt, copy=True).contiguous()

    ids = cfg.hybrid_layer_ids
    V = cfg.vocab_padded
    emb = w("model.embed_tokens.weight")
    if emb.shape[0] < V:
        emb = torch.cat([emb, emb.new_zeros((V - emb.shape[0], emb.shape[1]))])
    blocks = []
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}." + ("mamba_decoder." if i in ids else "")
        m = pre + "mamba."
        ssm = {
            "in_proj": w(m + "in_proj.weight", t=True),
            "out_proj": w(m + "out_proj.weight", t=True),
            "conv_w": w(m + "conv1d.weight")[:, 0, :].t().contiguous(),
            "A_log": w(m + "A_log", f32=True),
            "D_skip": w(m + "D", f32=True),
            "dt_bias": w(m + "dt_bias", f32=True),
            "norm": w(m + "norm.weight"),
        }
        if cfg.conv_bias:
            ssm["conv_b"] = w(m + "conv1d.bias")
        blocks.append({"norm1": w(pre + "input_layernorm.weight"), "ssm": ssm})
    shared = []
    for b in range(cfg.num_mem_blocks):
        st = f"model.layers.{ids[b]}.shared_transformer."
        a = st + "self_attn."
        shared.append({
            "norm1": w(st + "input_layernorm.weight"),
            "norm2": w(st + "pre_ff_layernorm.weight"),
            "attn": {k: w(a + f"{n}_proj.weight", t=True)
                     for k, n in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o"))},
            "mlp": {"w_gate_up": w(st + "feed_forward.gate_up_proj.weight", t=True),
                    "w_down": w(st + "feed_forward.down_proj.weight", t=True)},
        })
    apps = []
    for a, lid in enumerate(ids):
        ad = (f"model.layers.{ids[a % cfg.num_mem_blocks]}.shared_transformer."
              f"feed_forward.gate_up_proj_adapter_list.{a}.")
        apps.append({"linear": w(f"model.layers.{lid}.linear.weight", t=True),
                     "adapter_a": w(ad + "0.weight", t=True),
                     "adapter_b": w(ad + "1.weight", t=True)})
    return {"embed": emb, "final_norm": w("model.final_layernorm.weight"),
            "blocks": blocks, "shared_blocks": shared, "apps": apps}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _attention(blk, u: torch.Tensor, cfg: ArchConfig, rope: tuple,
               kv: Optional[dict]) -> torch.Tensor:
    """The shared block's attention over u [B, S, 2D] -> [B, S, D].  With
    ``kv`` ({'k', 'v'} [B, max_len, H, dh]) the step's K and V are written
    into the cache: a prefill ('len' 0) at rows 0..S-1, then causal flash
    attention over the prompt; a decode step (kv 'pos' int64 [1] and
    'kv_len' int32 [1] on the device, S == 1) at row 'pos', then the flash
    kernel over the cache's first 'kv_len' rows, which it reads itself
    (plain attention on CPU tensors)."""
    B, S, _ = u.shape
    H, dh = cfg.n_heads, cfg.d_head
    p = blk.attn.params()
    scale = (dh / 2) ** -0.5
    q = L.apply_rope_half((u @ p["wq"]).reshape(B, S, H, dh), rope)
    k = L.apply_rope_half((u @ p["wk"]).reshape(B, S, H, dh), rope)
    v = (u @ p["wv"]).reshape(B, S, H, dh)
    if kv is not None:
        obs.count("lm.kv_bytes", 2 * k.numel() * k.element_size())
    o = L.cached_attend(q, k, v, cfg, scale, kv)
    return o.reshape(B, S, H * dh) @ p["wo"]


def shared_block(model, h: torch.Tensor, x0: torch.Tensor, rope: tuple,
                 app: int, kv: Optional[dict] = None) -> torch.Tensor:
    """Application ``app`` of its shared block, then the application's
    linear: the term added to the next mamba layer's input.  ``rope``: the
    step's tables (``layers.rope_half_tables``)."""
    cfg = model.cfg
    b = app % cfg.num_mem_blocks
    blk = model.shared_blocks[b]
    with obs.span("lm.shared_block", (cfg.hybrid_layer_ids[app], b, app) if obs.ON else ()):
        u = L.rmsnorm(torch.cat([h, x0], dim=-1), blk.norm1.gamma, cfg.norm_eps)
        a = _attention(blk, u, cfg, rope, kv)
        a = L.rmsnorm(a, blk.norm2.gamma, cfg.norm_eps)
        ap = model.apps[app].params()
        y = L.gelu_mlp(blk.mlp.params(), a, (ap["adapter_a"], ap["adapter_b"]))
        return y @ ap["linear"]


def _mamba(blk, h: torch.Tensor, cfg: ArchConfig, add: Optional[torch.Tensor],
           cache: Optional[dict], i: int) -> torch.Tensor:
    """Mamba layer ``i``: h + mamba(rmsnorm(h + add)); with a cache, its
    states are read and replaced in place."""
    u = h if add is None else h + add
    u = L.rmsnorm(u, blk.norm1.gamma, cfg.norm_eps)
    if cache is None:
        return h + ssm_lib.ssm_block_apply(blk.ssm.params(), u, cfg)[0]
    c = {"conv": cache["conv"][i], "S": cache["S"][i]}
    y, nc = ssm_lib.ssm_block_apply(blk.ssm.params(), u, cfg, cache=c)
    c["conv"].copy_(nc["conv"])
    c["S"].copy_(nc["S"])
    return h + y


def layers(model, x0: torch.Tensor, positions: torch.Tensor,
           cache: Optional[dict] = None, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The published layer loop over the embeddings x0 [B, S, D]; with a
    cache, every layer's states and each application's KV are written
    into it.  ``pos`` (int64 [1] on the device, S == 1): a decode step at
    that position, the cache's 'len' unread (``decode_static``)."""
    cfg = model.cfg
    app_of = {lid: a for a, lid in enumerate(cfg.hybrid_layer_ids)}
    rope = L.rope_half_tables(positions, cfg.d_head, cfg.rope_theta, x0.dtype)
    if pos is not None:
        at = {"pos": pos, "kv_len": (pos + 1).to(torch.int32)}
    h = x0
    for i, blk in enumerate(model.blocks):
        a = app_of.get(i)
        t = None
        if a is not None:
            kv = None if cache is None else {
                "k": cache["k"][a], "v": cache["v"][a], "len": cache["len"]}
            if pos is not None:
                kv.update(at)
            t = shared_block(model, h, x0, rope, a, kv)
        h = _mamba(blk, h, cfg, t, cache, i)
    return h


def decode_static(model, cache: dict, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """A decode step with its position on the device: tokens [B, 1] at
    position ``pos`` (int64 [1]) -> logits [B, 1, V_padded], the caches
    updated in place and their 'len' unread.  Every shape and address is
    fixed from step to step, so ``DecodeGraph`` captures it once;
    ``transformer.decode_step`` runs it eagerly."""
    from repro_torch.models import transformer as T

    B = tok.shape[0]
    x0 = model.embed[tok]
    h = layers(model, x0, pos.expand(B, 1), cache, pos=pos)
    return T._logits(model, h)


class DecodeGraph:
    """``transformer.decode_step`` over one cache at a device position
    (``decode_static``) captured in a CUDA graph, so a decode step costs one
    replay on the host instead of ~5,000 launches; the published models'
    (Zamba2's here, Granite 4.0-H's through ``models/granite4h.py``), whose
    caches hold per-layer conv and SSM states ('conv', 'S') and per
    attention K and V ('k', 'v'), and DeepSeek-V3's
    (``models/deepseek_v3.py``), whose cache holds each layer's latent
    rows ('latent').
    Build it on an empty cache, before the prefill: the warm-up step it
    runs writes the cache's last KV or latent row (which no step of a
    batch of ``max_len - 1`` positions reads) and the conv and SSM states,
    which it zeroes again.  ``step(tok, idx)`` copies the tokens and the position
    in, replays, and returns the logits buffer [B, 1, V_padded] (valid
    until the next replay).  The spans and counters inside the step are
    not recorded while it replays; ``step`` counts the step's KV bytes and
    SSM chunks (or its MLA blocks and latent bytes) itself.
    ``decode_graph`` keeps the last one on the model."""

    def __init__(self, model, cache: dict):
        from repro_torch.models import transformer as T

        rows = cache["latent"] if "latent" in cache else cache["k"]
        dev = rows.device
        B, R = rows.shape[1], rows.shape[2]
        self.tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
        self.pos = torch.full((1,), R - 1, dtype=torch.long, device=dev)
        # what a step adds to the counters: the KV rows of each attention
        # and one SSM chunk a mamba layer, or one latent row an MLA block
        one = rows.shape[0] * B * rows[0, 0, 0].numel() * rows.element_size()
        self.counts = ({"lm.mla_blocks": rows.shape[0], "lm.mla_latent_bytes": one}
                       if "latent" in cache else
                       {"lm.kv_bytes": 2 * one, "lm.ssm_chunks": cache["S"].shape[0]})
        at = dict(cache, pos=self.pos)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with obs.paused():
            with torch.cuda.stream(side):
                T.decode_step(model, at, self.tok)  # warm-up
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.logits = T.decode_step(model, at, self.tok)[1]
        self.cache = cache
        self.reset()

    def reset(self) -> None:
        """An empty cache for the next batch: the conv and SSM states zeroed
        (the prefill starts from them); the KV and latent rows need
        nothing, since every row a step reads is written first in the same
        batch."""
        for name in ("conv", "S"):
            if name in self.cache:
                self.cache[name].zero_()
        self.cache["len"] = 0

    def step(self, tok: torch.Tensor, idx: int) -> torch.Tensor:
        self.tok.copy_(tok)
        self.pos.fill_(idx)
        self.graph.replay()
        for name, n in self.counts.items():
            obs.count(name, n)
        return self.logits


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device,
               dtype: torch.dtype) -> dict:
    """conv [L, B, K-1, d_inner + 2 G N] and S [L, B, H, N, dh] (f32, or
    float64 for a float64 model) per layer; K, V [n_apps, B, max_len, H,
    d_head] per application."""
    z = dict(dtype=dtype, device=device)
    G, N = cfg.ssm_groups, cfg.ssm_state
    kv = (cfg.n_apps, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, ssm_lib.CONV_K - 1,
                             cfg.d_inner + 2 * G * N), **z),
        "S": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads, N, cfg.ssm_head_dim),
                         dtype=L._acc(dtype), device=device),
        "k": torch.zeros(kv, **z), "v": torch.zeros(kv, **z), "len": 0,
    }


def decode_graph(model, batch: int, max_len: int) -> DecodeGraph:
    """The model's ``DecodeGraph`` (and its cache) for ``batch`` rows of
    ``max_len`` positions, reset for the next batch.  The model keeps one
    graph, the last captured: a batch of another shape, or a model whose
    parameters have moved since (a ``.to()``, ``transformer.param_tree``),
    replaces it (the graph reads the weights where they lay when it was
    captured)."""
    from repro_torch.models import transformer as T

    key = (batch, max_len, tuple(p.data_ptr() for p in model.parameters()))
    kept = model.__dict__.get("_decode_graph")
    if kept is not None and kept[0] == key:
        kept[1].reset()
        return kept[1]
    model.__dict__.pop("_decode_graph", None)
    del kept
    cache = T.init_cache(model.cfg, batch, max_len, device=model.embed.device,
                         dtype=model.embed.dtype)
    graph = DecodeGraph(model, cache)
    model.__dict__["_decode_graph"] = (key, graph)
    return graph
