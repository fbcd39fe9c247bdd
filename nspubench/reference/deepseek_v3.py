"""Plain reference of DeepSeek-V3's block as published, without q_lora
(``transformers``' ``DeepseekV3ForCausalLM``, model type ``deepseek_v3``;
Kanana-2-30B-A3B-Instruct): a full forward pass with no cache, no kernel
and every expert assignment computed (dropless), in float32 (or float64
on the CPU), written from the published equations over a state dict under
the published parameter names and a dict of the published config's keys.

    logits = forward(state, conf, tokens)            # [B, S, vocab]
    logits = forward(state, conf, tokens, at=p,      # at the positions p,
                     taps=t)                         # and t: each layer's
                                                     # latent rows and each
                                                     # MoE block's output there
    logits = forward(state, conf, tokens, route=r,   # each MoE block forced
                     taps=t)                         # to the experts r[m]
                                                     # (teacher forcing);
                                                     # t['route_differ']: its
                                                     # own choice's flips

Equations (the expanded form of ``DeepseekV3Attention``):

* h = embed[tokens];
* every layer: h = h + mla(rms(h)); then, u = rms'(h), h = h + ffn(u);
* mla: q = q_proj(u), per head [q_nope (qk_nope_head_dim), q_pe
  (qk_rope_head_dim)]; [c, k_pe] = kv_a_proj_with_mqa(u), c =
  rms_kv(c) (``kv_a_layernorm``); per head [k_nope, v] = kv_b_proj(c);
  RoPE (theta ``rope_theta``; inv_freq in f32 as ``transformers``
  computes it) on q_pe and on k_pe, the one rope head every head shares;
  k = [k_nope, k_pe], q = [q_nope, q_pe]; softmax(q k^T * scale) v,
  causal, scale (qk_nope + qk_rope)^-1/2; o_proj;
* ffn: in the first ``first_k_dense_replace`` layers a SwiGLU of width
  ``intermediate_size`` (down(silu(gate(u)) * up(u))); after them the
  MoE: scores = sigmoid(gate(u)) in f32, the top ``num_experts_per_tok``
  of scores + ``e_score_correction_bias`` (a stable descending sort: the
  lower id first on ties; one group), the gates those experts' scores
  over their sum + 1e-20, times ``routed_scaling_factor``; each chosen
  expert's SwiGLU of width ``moe_intermediate_size`` times its gate,
  summed; plus the shared experts, one SwiGLU of width
  ``n_shared_experts`` x ``moe_intermediate_size``;
* logits = rms(h) @ lm_head^T (untied).

Departures from ``transformers``' form, none of which moves q . k or the
logits beyond f32 rounding: the rope dims are rotated in pair order,
(x[2i], x[2i + 1]) by theta_i, where ``apply_rotary_pos_emb_interleave``
permutes each rope head to halves first and rotates the halves (the same
q . k; the latent rows here keep the pair order, as the program's cache
does); the scale is the f32 nearest of (qk_nope + qk_rope)^-1/2 (the
flash kernel's f32 argument; 3e-9 of it); RoPE's angles are computed in
the compute dtype (``transformers`` computes them in f32 whatever the
model's dtype); the attention runs in blocks of ``q_block`` query rows so
that 32,768 positions fit; the experts run on the tokens routed to them
(gathered), not through a dense all-experts product.

``acc=torch.bfloat16`` is the control, every sum held in bf16 where the
configuration states f32 (the projections' and the experts' products a
``reference/zamba2.py`` ``ACC_BLOCK`` terms at a time, the router's
logits, a token's k expert outputs, the residual stream after every
branch); ``act=torch.bfloat16`` the witness at the configuration's own
precision (activations rounded to bf16 where a bf16 model holds them, the
router's logits and the attention's sums in the compute dtype).  Weights
are cast to the compute dtype as each layer reads them, an expert when its
tokens are computed; with a ``LazyState`` a tensor is drawn when it is
read, so a check at full width holds one layer in float32 at a time.  TF32
is off inside ``forward``.

``LazyState`` and ``init_state`` draw the weights by
``DeepseekV3PreTrainedModel._init_weights``' rule (linears, the router and
the embedding N(0, initializer_range^2), norms 1, no pad row), each tensor
from its own generator seeded from the run's seed and the tensor's name;
``e_score_correction_bias``, zeros under that rule, is drawn N(0, 0.05^2)
per expert (a trained model's is not zero, and at zero the choice and the
gates would read the same scores).  Imports nothing but torch and
``reference/zamba2.py`` and ``reference/granite4h.py``.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from nspubench.reference import granite4h as g4
from nspubench.reference import zamba2 as z

BIAS_STD = 0.05  # e_score_correction_bias's draw (assumed)


def dims(conf: dict) -> dict:
    H = conf["num_attention_heads"]
    dn, dr, dv = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"], conf["v_head_dim"]
    return dict(D=conf["hidden_size"], H=H, dn=dn, dr=dr, dv=dv, r=conf["kv_lora_rank"],
                E=conf["n_routed_experts"], k=conf["num_experts_per_tok"],
                F=conf["intermediate_size"], Fe=conf["moe_intermediate_size"],
                Fs=conf["n_shared_experts"] * conf["moe_intermediate_size"],
                dense=conf["first_k_dense_replace"], V=conf["vocab_size"],
                L=conf["num_hidden_layers"])


# --------------------------------------------------------------------------
# the published init
# --------------------------------------------------------------------------
def tensor_specs(conf: dict) -> list:
    """(name, shape, rule) of every tensor of the state dict, in a fixed
    order; rule 'normal' N(0, initializer_range^2) (``nn.Linear``, the
    router, ``nn.Embedding``), 'ones' (norms), 'bias' N(0, BIAS_STD^2)
    (``e_score_correction_bias``, f32)."""
    d = dims(conf)
    D, H, r, E = d["D"], d["H"], d["r"], d["E"]

    def swiglu(pre, F):
        return [(pre + "gate_proj.weight", (F, D), "normal"),
                (pre + "up_proj.weight", (F, D), "normal"),
                (pre + "down_proj.weight", (D, F), "normal")]

    out = [("model.embed_tokens.weight", (d["V"], D), "normal")]
    for i in range(d["L"]):
        pre = f"model.layers.{i}."
        a = pre + "self_attn."
        out += [(pre + "input_layernorm.weight", (D,), "ones"),
                (a + "q_proj.weight", (H * (d["dn"] + d["dr"]), D), "normal"),
                (a + "kv_a_proj_with_mqa.weight", (r + d["dr"], D), "normal"),
                (a + "kv_a_layernorm.weight", (r,), "ones"),
                (a + "kv_b_proj.weight", (H * (d["dn"] + d["dv"]), r), "normal"),
                (a + "o_proj.weight", (D, H * d["dv"]), "normal"),
                (pre + "post_attention_layernorm.weight", (D,), "ones")]
        m = pre + "mlp."
        if i < d["dense"]:
            out += swiglu(m, d["F"])
        else:
            out += [(m + "gate.weight", (E, D), "normal"),
                    (m + "gate.e_score_correction_bias", (E,), "bias")]
            for e in range(E):
                out += swiglu(m + f"experts.{e}.", d["Fe"])
            out += swiglu(m + "shared_experts.", d["Fs"])
    out += [("model.norm.weight", (D,), "ones"), ("lm_head.weight", (d["V"], D), "normal")]
    return out


def draw(conf: dict, name: str, shape: tuple, rule: str, seed: int, device,
         dtype=torch.bfloat16) -> torch.Tensor:
    """Tensor ``name`` by its rule, on ``device``: the normal draws in
    float32 from the tensor's own generator, then cast to ``dtype``; the
    router's bias stays float32."""
    f32 = dict(dtype=torch.float32, device=device)
    if rule in ("normal", "bias"):
        std = conf.get("initializer_range", 0.02) if rule == "normal" else BIAS_STD
        g = torch.Generator(device=device).manual_seed(g4.tensor_seed(seed, name))
        x = torch.empty(shape, **f32).normal_(0.0, std, generator=g)
        return x if rule == "bias" else x.to(dtype)
    if rule == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
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
def rope_tables(S: int, dr: int, theta: float, dtype, device) -> tuple:
    """cos and sin [S, dr / 2] of positions 0..S-1: inv_freq in f32 (as
    ``transformers``' default rope init), the angles in ``dtype``."""
    inv = 1.0 / (theta ** (torch.arange(0, dr, 2, dtype=torch.int64, device=device)
                           .float() / dr))
    ang = torch.arange(S, device=device).to(dtype)[:, None] * inv.to(dtype)[None, :]
    return torch.cos(ang), torch.sin(ang)


def rope_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [.., S, heads, dr]: the pairs (x[2i], x[2i + 1]) rotated by
    theta_i, kept in pair order."""
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).flatten(-2)


def _swiglu(x, gate, up, down, acc, act):
    g, u = z._mm(x, gate, acc, act), z._mm(x, up, acc, act)
    return z._mm(z._round(torch.nn.functional.silu(g) * u, act), down, acc, act)


def _mla(u, w, conf, d, rope, acc, act, q_block):
    """The expanded MLA over u [B, S, D] -> (its output, the latent rows
    [B, S, r + dr]: c after its norm, k_pe after RoPE)."""
    B, S, _ = u.shape
    H, dn, dr, dv, r = d["H"], d["dn"], d["dr"], d["dv"], d["r"]
    rd = lambda x: z._round(x, act)  # noqa: E731
    q = z._mm(u, w["q"], acc, act).view(B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], rd(rope_pairs(q[..., dn:], *rope))], dim=-1)
    kva = z._mm(u, w["kv_a"], acc, act)
    c = rd(z._rms(kva[..., :r], w["kv_norm"], conf["rms_norm_eps"]))
    k_pe = rd(rope_pairs(kva[..., None, r:], *rope))  # [B, S, 1, dr]
    kv = z._mm(c, w["kv_b"], acc, act).view(B, S, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe.expand(B, S, H, dr)], dim=-1)
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, kv[..., dn:]))
    del kv
    scale = float(np.float32((dn + dr) ** -0.5))
    outs = []
    for q0 in range(0, S, q_block):
        q1 = min(q0 + q_block, S)
        s = (q[:, :, q0:q1] @ k[:, :, :q1].transpose(-1, -2)) * scale
        future = torch.ones((q1 - q0, q1), dtype=torch.bool, device=u.device).triu(q0 + 1)
        s = s.masked_fill(future, -float("inf"))
        outs.append(rd(torch.softmax(s, dim=-1)) @ v[:, :, :q1])
        del s
    o = rd(torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * dv))
    return z._mm(o, w["o"], acc, act), torch.cat([c, k_pe[:, :, 0]], dim=-1)


def _moe(u, get, pre, conf, d, acc, act, gates_tap=None, route=None, differ=None,
         chosen=None):
    """The MoE's routed experts over u [B, S, D] (dropless, each expert on
    the tokens routed to it); ``gates_tap`` (a list) gets the gates
    scattered over the experts [B, S, E] (0 where not chosen).  ``route``
    ([B, S, k]) forces the chosen experts (teacher forcing of the routing:
    the gates are still those experts' unbiased scores, normalised and
    scaled); ``differ`` (a list) then gets the number of tokens whose own
    top k of scores + bias is another set; ``chosen`` (a list) the chosen
    experts [B, S, k]."""
    B, S, D = u.shape
    x = u.reshape(B * S, D)
    k = d["k"]
    router = get(pre + "gate.weight")
    if acc is None:
        logits = z._round(x, act) @ z._round(router, act).T
    else:
        logits = z._mm(x, router, acc)
    scores = torch.sigmoid(logits)
    bias = get(pre + "gate.e_score_correction_bias")
    _, order = torch.sort(scores + bias, dim=-1, descending=True, stable=True)
    ids = order[:, :k]
    if route is not None:
        forced = route.reshape(B * S, k).to(device=u.device, dtype=torch.long)
        if differ is not None:
            own, want = torch.sort(ids, dim=-1)[0], torch.sort(forced, dim=-1)[0]
            differ.append(int((own != want).any(dim=-1).sum()))
        ids = forced
    if chosen is not None:
        chosen.append(ids.view(B, S, k))
    gates = scores.gather(1, ids)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-20) * conf["routed_scaling_factor"]
    if gates_tap is not None:
        gates_tap.append(torch.zeros_like(scores).scatter_(1, ids, gates).view(B, S, -1))
    gates = z._round(gates, act)
    out = torch.zeros((B * S, k, D), dtype=u.dtype, device=u.device)
    for e in range(d["E"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            ex = pre + f"experts.{e}."
            ye = _swiglu(x[tok], get(ex + "gate_proj.weight"), get(ex + "up_proj.weight"),
                         get(ex + "down_proj.weight"), acc, act)
            out[tok, slot] = z._round(ye * gates[tok, slot, None], act)
    return g4._sum_slots(out, acc, u.dtype).reshape(B, S, D)


def forward(state, conf: dict, tokens: torch.Tensor, *, dtype=torch.float32,
            acc: Optional[torch.dtype] = None, act: Optional[torch.dtype] = None,
            device=None, taps: Optional[dict] = None, at: Optional[torch.Tensor] = None,
            route: Optional[list] = None, q_block: int = 256) -> torch.Tensor:
    """Logits [B, S, vocab] in ``dtype`` of ``tokens`` [B, S] (positions
    0..S-1), on ``device`` (default: the tokens'), or [B, len(at), vocab]
    at the positions ``at``; ``acc`` bf16 is the control, ``act`` bf16 the
    configuration's precision.  ``taps`` (a dict) gets 'latent', each
    layer's latent rows [B, S or len(at), r + dr] (c after its norm, then
    k_pe after RoPE, as the program's cache holds them), 'moe', each MoE
    block's output [B, S or len(at), D] (the routed experts', before the
    shared experts), and 'gates', the first MoE block's gates scattered
    over the experts [B, S or len(at), E], and 'route', each MoE block's
    chosen experts [B, S, k] at every position.  ``route`` (a list, one
    [B, S, k] a MoE block) forces each MoE block's chosen experts (the
    program's, teacher-forced as its tokens are); ``taps`` then also gets
    'route_differ', a MoE block's count of tokens whose own choice is
    another set of experts."""
    device = tokens.device if device is None else torch.device(device)
    d = dims(conf)
    eps = conf["rms_norm_eps"]

    def get(name):
        return state[name].to(device=device, dtype=dtype)

    def pick(x):
        return x if at is None else x.index_select(1, at.to(device))

    r = lambda x: z._round(x, act)  # noqa: E731

    def residual(h, y):
        h = r(h + y)
        return h if acc is None else h.to(acc).to(dtype)

    lat, moes, gates, differ, chosen = [], [], [], [], []
    with torch.inference_mode(), z._no_tf32():
        tokens = tokens.to(device)
        S = tokens.shape[1]
        rope = rope_tables(S, d["dr"], conf["rope_theta"], dtype, device)
        h = r(get("model.embed_tokens.weight")[tokens])
        for i in range(d["L"]):
            pre = f"model.layers.{i}."
            a = pre + "self_attn."
            u = r(z._rms(h, get(pre + "input_layernorm.weight"), eps))
            w = {"q": get(a + "q_proj.weight"), "kv_a": get(a + "kv_a_proj_with_mqa.weight"),
                 "kv_norm": get(a + "kv_a_layernorm.weight"),
                 "kv_b": get(a + "kv_b_proj.weight"), "o": get(a + "o_proj.weight")}
            y, rows = _mla(u, w, conf, d, rope, acc, act, q_block)
            del w
            if taps is not None:
                lat.append(pick(rows))
            del rows
            h = residual(h, y)
            u = r(z._rms(h, get(pre + "post_attention_layernorm.weight"), eps))
            m = pre + "mlp."
            if i < d["dense"]:
                y = _swiglu(u, get(m + "gate_proj.weight"), get(m + "up_proj.weight"),
                            get(m + "down_proj.weight"), acc, act)
            else:
                first = taps is not None and i == d["dense"]
                y = _moe(u, get, m, conf, d, acc, act, gates if first else None,
                         None if route is None else route[i - d["dense"]], differ,
                         chosen if taps is not None else None)
                if taps is not None:
                    moes.append(pick(y))
                s = m + "shared_experts."
                y = r(y + _swiglu(u, get(s + "gate_proj.weight"), get(s + "up_proj.weight"),
                                  get(s + "down_proj.weight"), acc, act))
            h = residual(h, y)
        if taps is not None:
            taps.update(latent=lat, moe=moes, gates=[pick(g) for g in gates], route=chosen)
            if route is not None:
                taps["route_differ"] = differ
        h = r(z._rms(pick(h), get("model.norm.weight"), eps))
        return z._mm(h, get("lm_head.weight"), acc, act)
