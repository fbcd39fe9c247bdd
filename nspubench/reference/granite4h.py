"""Plain reference of Granite 4.0-H as published (``transformers``'
``GraniteMoeHybridForCausalLM``, model type ``granitemoehybrid``): a full
forward pass with no cache, no chunking, no kernel and every expert
assignment computed (dropless), in float32 (or float64 on the CPU),
written from the published equations over a state dict under the
published parameter names and a dict of the published config's keys.

    logits = forward(state, conf, tokens)            # [B, S, vocab]
    logits = forward(state, conf, tokens, taps=t)    # and t: each attention
                                                     # layer's K and V, each
                                                     # mamba layer's final SSM
                                                     # state, each MoE block's
                                                     # output

Equations (``layer_types`` names each layer's mixer; m = residual_multiplier):

* h = embed[tokens] * embedding_multiplier;
* every layer: h = h + m * mixer(rms(h)); then, u = rms'(h), h = h + m *
  (moe(u) + shared(u));
* mamba mixer (one group): z, xBC, dt = in_proj(u); xBC = silu(causal
  depthwise conv(xBC) + bias); x, B, C split; dt = softplus(dt + dt_bias),
  not clamped; A = -exp(A_log); S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T,
  y_t = C_t . S_t + D x_t; y = rms over d_inner of (y * silu(z)), times the
  norm's weight; out_proj(y) (the Mamba2 pieces of ``reference/zamba2.py``,
  with its clamp at 0, which softplus never goes under);
* attention: GQA (query head h reads KV head h // (heads / kv_heads)), no
  position embedding, scores scaled by ``attention_multiplier``, causal;
  o_proj;
* moe: logits = router(u) [T, E]; the top ``num_experts_per_tok`` (a
  stable descending sort, the lower id first on ties), a softmax over
  them, the gates in the activations' dtype; each chosen expert's SwiGLU,
  silu(gate) * up from ``input_linear`` [E, 2F, D] (gate rows first), then
  ``output_linear`` [E, D, F], times its gate; each token's k outputs
  summed; shared(u) the same SwiGLU of width ``shared_intermediate_size``;
* logits = rms(h) @ embed^T / logits_scaling (tied).

The SSD runs as the token-by-token recurrence (``ssd='recurrence'``, the
CPU tests') or as the whole sequence's quadratic form (``'quadratic'``,
exponents summed in float64), as ``reference/zamba2.py`` defines them.
``acc=torch.bfloat16`` is the control, every sum held in bf16 where the
configuration states f32 (products' inputs rounded to bf16 and summed in
bf16, ``reference/zamba2.py``'s ``ACC_BLOCK`` terms at a time; the SSM's
sums, the k expert outputs a token and the residual stream after every
branch); ``act=torch.bfloat16``
the witness at the configuration's own precision (activations rounded to
bf16 where a bf16 model holds them, every sum in the compute dtype).
Weights are cast to the compute dtype one layer at a time; with a
``LazyState`` a layer's weights are drawn when the layer reads them, so a
check at full width holds one layer in float32 at a time.  TF32 is off
inside ``forward``.

``LazyState`` and ``init_state`` draw the weights by
``GraniteMoeHybridPreTrainedModel._init_weights``' rule, each tensor from
its own generator seeded from the run's seed and the tensor's name.
Imports nothing but torch and ``reference/zamba2.py``.
"""
from __future__ import annotations

import hashlib
from collections.abc import Mapping
from typing import Optional

import torch

from nspubench.reference import zamba2 as z

# the mamba pieces' clamp of softplus(dt): none (softplus is never below 0)
_NO_CLAMP = {"time_step_min": 0.0}


def dims(conf: dict) -> dict:
    D = conf["hidden_size"]
    Di = conf["mamba_expand"] * D
    G, N = conf["mamba_n_groups"], conf["mamba_d_state"]
    heads = conf["num_attention_heads"]
    return dict(D=D, Di=Di, H=conf["mamba_n_heads"], P=conf["mamba_d_head"], G=G, N=N,
                K=conf["mamba_d_conv"], conv=Di + 2 * G * N, heads=heads,
                kv_heads=conf["num_key_value_heads"], hd=D // heads,
                E=conf["num_local_experts"], k=conf["num_experts_per_tok"],
                F=conf["intermediate_size"], Fs=conf["shared_intermediate_size"],
                V=conf["vocab_size"], L=conf["num_hidden_layers"])


# --------------------------------------------------------------------------
# the published init
# --------------------------------------------------------------------------
def tensor_specs(conf: dict) -> list:
    """(name, shape, rule) of every tensor of the state dict, in a fixed
    order; rule 'normal' N(0, initializer_range^2) (linears, the conv, the
    experts, the embedding: ``nn.Linear``, ``nn.Conv1d``,
    ``GraniteMoeHybridParallelExperts``, ``nn.Embedding``), 'ones' (norms,
    D), 'zeros' (conv biases), 'dt_bias' (1) and 'A_log' (log 1..H)."""
    d = dims(conf)
    D, Di, H, E, F, Fs = d["D"], d["Di"], d["H"], d["E"], d["F"], d["Fs"]
    hq, hkv = d["heads"] * d["hd"], d["kv_heads"] * d["hd"]
    out = [("model.embed_tokens.weight", (d["V"], D), "normal")]
    for i, kind in enumerate(conf["layer_types"]):
        pre = f"model.layers.{i}."
        out.append((pre + "input_layernorm.weight", (D,), "ones"))
        if kind == "mamba":
            m = pre + "mamba."
            out += [(m + "in_proj.weight", (Di + d["conv"] + H, D), "normal"),
                    (m + "conv1d.weight", (d["conv"], 1, d["K"]), "normal"),
                    (m + "conv1d.bias", (d["conv"],), "zeros"),
                    (m + "dt_bias", (H,), "dt_bias"), (m + "A_log", (H,), "A_log"),
                    (m + "D", (H,), "ones"), (m + "norm.weight", (Di,), "ones"),
                    (m + "out_proj.weight", (D, Di), "normal")]
        else:
            a = pre + "self_attn."
            out += [(a + "q_proj.weight", (hq, D), "normal"),
                    (a + "k_proj.weight", (hkv, D), "normal"),
                    (a + "v_proj.weight", (hkv, D), "normal"),
                    (a + "o_proj.weight", (D, hq), "normal")]
        moe = pre + "block_sparse_moe."
        out += [(pre + "post_attention_layernorm.weight", (D,), "ones"),
                (moe + "router.layer.weight", (E, D), "normal"),
                (moe + "input_linear.weight", (E, 2 * F, D), "normal"),
                (moe + "output_linear.weight", (E, D, F), "normal"),
                (pre + "shared_mlp.input_linear.weight", (2 * Fs, D), "normal"),
                (pre + "shared_mlp.output_linear.weight", (D, Fs), "normal")]
    out.append(("model.norm.weight", (D,), "ones"))
    return out


def tensor_seed(seed: int, name: str) -> int:
    """The 63-bit seed of tensor ``name``'s own generator."""
    h = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def draw(conf: dict, name: str, shape: tuple, rule: str, seed: int, device,
         dtype=torch.bfloat16) -> torch.Tensor:
    """Tensor ``name`` by its rule, on ``device``: the normal draws in
    float32 from the tensor's own generator, then cast to ``dtype``; the
    SSM gains (dt_bias, A_log, D) stay float32."""
    std = conf.get("initializer_range", 0.02)
    f32 = dict(dtype=torch.float32, device=device)
    if rule == "normal":
        g = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
        return torch.empty(shape, **f32).normal_(0.0, std, generator=g).to(dtype)
    if rule == "ones":
        return torch.ones(shape, **f32) if name.endswith(".D") else torch.ones(
            shape, dtype=dtype, device=device)
    if rule == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if rule == "dt_bias":
        return torch.ones(shape, **f32)
    if rule == "A_log":
        return torch.log(torch.arange(1, shape[0] + 1, **f32))
    raise ValueError(rule)


class LazyState(Mapping):
    """The state dict of ``seed`` that draws a tensor each time it is read
    (the same values every time), so that neither the program's loader nor
    the check ever holds the whole model twice."""

    def __init__(self, conf: dict, seed: int, device, dtype=torch.bfloat16):
        self.conf, self.seed, self.device, self.dtype = conf, int(seed), device, dtype
        self.specs = {n: (s, r) for n, s, r in tensor_specs(conf)}

    def __getitem__(self, name: str) -> torch.Tensor:
        shape, rule = self.specs[name]
        return draw(self.conf, name, shape, rule, self.seed, self.device, self.dtype)

    def __iter__(self):
        return iter(self.specs)

    def __len__(self) -> int:
        return len(self.specs)


def init_state(conf: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Every tensor of ``LazyState(conf, seed, device, dtype)``, drawn."""
    lazy = LazyState(conf, seed, device, dtype)
    return {n: lazy[n] for n in lazy}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _sum_slots(out: torch.Tensor, acc, dtype) -> torch.Tensor:
    """Each token's k slot outputs [T, k, D] summed, in ``dtype``, or with
    ``acc`` another dtype, added one at a time in ``acc``."""
    if acc is None or acc == dtype:
        return out.sum(dim=1)
    y = out[:, 0].to(acc)
    for j in range(1, out.shape[1]):
        y = (y.to(dtype) + out[:, j]).to(acc)
    return y.to(dtype)


def _swiglu(x, w_in, w_out, acc, act):
    """silu(gate) * up from w_in [2F, D] (gate rows first), then w_out
    [D, F]."""
    gate, up = z._mm(x, w_in, acc, act).chunk(2, dim=-1)
    return z._mm(z._round(torch.nn.functional.silu(gate) * up, act), w_out, acc, act)


def _moe(u, w, d, acc, act):
    """The dropless MoE over u [B, S, D]."""
    B, S, D = u.shape
    x = u.reshape(B * S, D)
    k = d["k"]
    logits = z._mm(x, w["router"], acc, act)
    vals, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    ids = order[:, :k]
    gates = z._round(torch.softmax(vals[:, :k], dim=-1), act)
    out = torch.zeros((B * S, k, D), dtype=u.dtype, device=u.device)
    for e in range(d["E"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            ye = _swiglu(x[tok], w["w_in"][e], w["w_out"][e], acc, act)
            out[tok, slot] = z._round(ye * gates[tok, slot, None], act)
    return _sum_slots(out, acc, u.dtype).reshape(B, S, D)


def _attention(u, w, conf, d, acc, act, taps=None, head_block=8):
    """GQA over u with no position embedding; ``taps`` (a list) gets (K,
    V), each [B, S, kv_heads, hd], the layout of a KV cache."""
    B, S, _ = u.shape
    hq, hkv, hd = d["heads"], d["kv_heads"], d["hd"]
    q = z._mm(u, w["q"], acc, act).view(B, S, hq, hd).transpose(1, 2)
    k = z._mm(u, w["k"], acc, act).view(B, S, hkv, hd).transpose(1, 2)
    v = z._mm(u, w["v"], acc, act).view(B, S, hkv, hd).transpose(1, 2)
    if taps is not None:
        taps.append((k.transpose(1, 2), v.transpose(1, 2)))
    rep = hq // hkv
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    future = torch.ones((S, S), dtype=torch.bool, device=u.device).triu(1)
    outs = []
    for h0 in range(0, hq, head_block):
        s = (q[:, h0: h0 + head_block] @ k[:, h0: h0 + head_block].transpose(-1, -2)
             ) * conf["attention_multiplier"]
        s = s.masked_fill(future, -float("inf"))
        outs.append(z._round(torch.softmax(s, dim=-1), act) @ v[:, h0: h0 + head_block])
    o = z._round(torch.cat(outs, dim=1).transpose(1, 2).reshape(B, S, hq * hd), act)
    return z._mm(o, w["o"], acc, act)


def forward(state, conf: dict, tokens: torch.Tensor, *, dtype=torch.float32,
            ssd: str = "recurrence", acc: Optional[torch.dtype] = None,
            act: Optional[torch.dtype] = None, device=None,
            taps: Optional[dict] = None) -> torch.Tensor:
    """Logits [B, S, vocab] in ``dtype`` of ``tokens`` [B, S], on
    ``device`` (default: the tokens'); ``acc`` bf16 is the control, ``act``
    bf16 the configuration's precision.  ``taps`` (a dict) gets 'k' and
    'v', each attention layer's K and V [B, S, kv_heads, hd] (as a KV
    cache holds them), 'S', each mamba layer's final SSM state [B, H, N, P]
    (as the SSM cache holds it), and 'moe', each MoE block's output [B, S,
    D] (the routed experts', before the shared expert)."""
    device = tokens.device if device is None else torch.device(device)
    ssd_acc = dtype if acc is None else acc
    d = dims(conf)
    eps = conf["rms_norm_eps"]
    mult = conf["residual_multiplier"]

    def get(name):
        return state[name].to(device=device, dtype=dtype)

    kv = [] if taps is not None else None
    states, moes = [], []
    r = lambda x: z._round(x, act)  # noqa: E731

    def residual(h, y):
        h = r(h + r(y * mult))
        return h if acc is None else h.to(acc).to(dtype)

    with torch.inference_mode(), z._no_tf32():
        tokens = tokens.to(device)
        emb = get("model.embed_tokens.weight")
        h = r(emb[tokens] * conf["embedding_multiplier"])
        for i, kind in enumerate(conf["layer_types"]):
            pre = f"model.layers.{i}."
            u = r(z._rms(h, get(pre + "input_layernorm.weight"), eps))
            if kind == "mamba":
                m = pre + "mamba."
                w = {"in_proj": get(m + "in_proj.weight"), "out_proj": get(m + "out_proj.weight"),
                     "conv_w": get(m + "conv1d.weight"), "conv_b": get(m + "conv1d.bias"),
                     "dt_bias": get(m + "dt_bias"), "A_log": get(m + "A_log"),
                     "D": get(m + "D"), "norm": get(m + "norm.weight")}
                y, fin = z._mamba(u, w, _NO_CLAMP, d, ssd, ssd_acc, act, eps)
                if taps is not None:
                    states.append(fin)
            else:
                a = pre + "self_attn."
                y = _attention(u, {n: get(a + f"{n}_proj.weight") for n in "qkvo"}, conf, d,
                               acc, act, kv)
            h = residual(h, y)
            u = r(z._rms(h, get(pre + "post_attention_layernorm.weight"), eps))
            moe = pre + "block_sparse_moe."
            y = _moe(u, {"router": get(moe + "router.layer.weight"),
                         "w_in": get(moe + "input_linear.weight"),
                         "w_out": get(moe + "output_linear.weight")}, d, acc, act)
            if taps is not None:
                moes.append(y)
            y = r(y + _swiglu(u, get(pre + "shared_mlp.input_linear.weight"),
                              get(pre + "shared_mlp.output_linear.weight"), acc, act))
            h = residual(h, y)
        if taps is not None:
            taps.update(k=[k for k, _ in kv], v=[v for _, v in kv], S=states, moe=moes)
        h = r(z._rms(h, get("model.norm.weight"), eps))
        return z._mm(h, emb, acc, act) / conf["logits_scaling"]
