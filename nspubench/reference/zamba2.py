"""Plain reference of Zamba2 as published (``transformers``'
``Zamba2ForCausalLM``, arXiv:2411.15242): a full forward pass with no
cache, no chunking and no kernel, in float32 (or float64 on the CPU),
written from the published equations over a state dict under the
published parameter names and a dict of the published config's keys.

    logits = forward(state, conf, tokens)            # [B, S, vocab]
    logits = forward(state, conf, tokens, taps=t)    # and t: each application's
                                                     # K and V, each layer's final
                                                     # SSM state

Equations (x0 = the token embeddings, h = x0; ``hybrid_layer_ids`` ids,
application a of shared block a % num_mem_blocks):

* mamba layer i: h = h + mamba_i(rms(h)); at a hybrid layer the shared
  block's output t, through the application's linear, is added to the
  mamba layer's input only: h = h + mamba_i(rms(h + linear_a(t)));
* shared block: u = rms(concat[h, x0]) (width 2 hidden); MHA over u with
  head dim 2 hidden / heads, RoPE (theta ``rope_theta``, halves rotated)
  on q and k, scores scaled by (head_dim / 2)^-1/2, causal; o_proj to
  hidden; rms; gate, up = gate_up(a) + adapter_a(a); down(gelu(gate) * up)
  with the exact (erf) GELU; no residual inside the block;
* mamba: z, xBC, dt = in_proj(u); xBC = silu(causal depthwise conv(xBC) +
  bias); x, B, C split (B and C per group, head h reads group h // (H /
  G)); dt = max(softplus(dt + dt_bias), time_step_min); A = -exp(A_log);
  S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T, y_t = C_t . S_t + D x_t;
  y = rms over groups of d_inner / G of (y * silu(z)), times the norm's
  weight; out_proj(y);
* logits = rms(h) @ embed^T (tied).

The SSD runs as the token-by-token recurrence (``ssd='recurrence'``, what
the CPU tests use) or as the whole sequence's quadratic form
(``ssd='quadratic'``: y = (L o C B^T) (dt x) with L_ij = exp(sum_{j<t<=i}
dt_t A) for j <= i, its exponents summed in float64, heads in blocks),
which is independent of any chunked scan.  ``acc=torch.bfloat16`` is the
control, every sum held in bf16 where the configuration states f32: each
product's inputs rounded to bf16 (as a bf16 model's activations are) and
its sum over the contracted dim accumulated in bf16 a block of
``ACC_BLOCK`` terms at a time (a tensor core's k16 step, its running sum
rounded to bf16 after each); the SSM's sums likewise (the recurrence's
state rounded every step; the quadratic form's sum over keys accumulated
in bf16 a block at a time), and the residual stream's after every layer.
``act=torch.bfloat16`` is the configuration's own precision, the witness
of what bf16 rounding alone does: the activations rounded to bf16 where a
bf16 model holds them (every product's inputs and output, the norms', the
conv's, the SSM's output and the quadratic form's operands, the attention
probabilities, the residual stream after every layer), every sum in the
compute dtype.  One layer's weights are cast to the compute dtype at a
time, so the full model fits beside its bf16 weights on one card.  TF32
is off for matmuls and cuDNN inside ``forward``.

``init_state`` draws a random state dict by ``Zamba2PreTrainedModel.
_init_weights``' rule.  Imports nothing but torch.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

ACC_BLOCK = 16  # terms a bf16 running sum takes at a time in the control


def hybrid_ids(conf: dict) -> list:
    return list(conf["hybrid_layer_ids"])


def dims(conf: dict) -> dict:
    D = conf["hidden_size"]
    Di = conf["mamba_expand"] * D
    H = conf["n_mamba_heads"]
    G, N = conf["mamba_ngroups"], conf["mamba_d_state"]
    heads = conf["num_attention_heads"]
    return dict(D=D, Di=Di, H=H, P=Di // H, G=G, N=N, K=conf["mamba_d_conv"],
                F=conf["intermediate_size"], heads=heads, hd=2 * D // heads,
                conv=Di + 2 * G * N, r=conf["adapter_rank"], V=conf["vocab_size"])


# --------------------------------------------------------------------------
# the published init
# --------------------------------------------------------------------------
def init_state(conf: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """A state dict under ``Zamba2ForCausalLM``'s names, drawn on
    ``device`` from ``seed`` by ``_init_weights``' rule: every linear and
    conv weight N(0, initializer_range^2), conv biases 0, the embedding
    N(0, initializer_range^2) with the pad row 0, norms 1, A_log = log(1..H),
    D 1, dt_bias the inverse softplus of dt drawn log-uniform over
    [time_step_min, time_step_max] and floored at time_step_floor.  Shared
    blocks and adapters appear once, at the first hybrid layer that uses
    them, as a state dict of the published checkpoint holds them.  The
    draws are made in float32, then cast to ``dtype`` (the SSM gains stay
    float32)."""
    d = dims(conf)
    D, Di, H, F, r = d["D"], d["Di"], d["H"], d["F"], d["r"]
    std = conf.get("initializer_range", 0.02)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    ids = hybrid_ids(conf)
    nmem = conf["num_mem_blocks"]
    out: dict = {}

    def normal(name, *shape):
        w = torch.empty(shape, device=device).normal_(0.0, std, generator=gen)
        out[name] = w.to(dtype)
        return out[name]

    def ones(name, n):
        out[name] = torch.ones((n,), dtype=dtype, device=device)

    emb = normal("model.embed_tokens.weight", d["V"], D)
    emb[conf.get("pad_token_id", 0)] = 0
    lo, hi = math.log(conf["time_step_min"]), math.log(conf["time_step_max"])
    for i in range(conf["num_hidden_layers"]):
        pre = f"model.layers.{i}." + ("mamba_decoder." if i in ids else "")
        m = pre + "mamba."
        normal(m + "in_proj.weight", Di + d["conv"] + H, D)
        normal(m + "conv1d.weight", d["conv"], 1, d["K"])
        out[m + "conv1d.bias"] = torch.zeros((d["conv"],), dtype=dtype, device=device)
        normal(m + "out_proj.weight", D, Di)
        ones(m + "norm.weight", Di)
        dt = torch.exp(torch.rand((H,), generator=gen, device=device) * (hi - lo) + lo)
        dt = dt.clamp(min=conf["time_step_floor"])
        out[m + "dt_bias"] = dt + torch.log(-torch.expm1(-dt))
        out[m + "A_log"] = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                                  device=device))
        out[m + "D"] = torch.ones((H,), dtype=torch.float32, device=device)
        ones(pre + "input_layernorm.weight", D)
    A = 2 * D
    hd = d["heads"] * d["hd"]
    for b in range(nmem):
        st = f"model.layers.{ids[b]}.shared_transformer."
        for n in ("q", "k", "v"):
            normal(st + f"self_attn.{n}_proj.weight", hd, A)
        normal(st + "self_attn.o_proj.weight", D, hd)
        normal(st + "feed_forward.gate_up_proj.weight", 2 * F, D)
        normal(st + "feed_forward.down_proj.weight", D, F)
        ones(st + "input_layernorm.weight", A)
        ones(st + "pre_ff_layernorm.weight", D)
    for a, lid in enumerate(ids):
        ad = (f"model.layers.{ids[a % nmem]}.shared_transformer.feed_forward."
              f"gate_up_proj_adapter_list.{a}.")
        normal(ad + "0.weight", r, D)
        normal(ad + "1.weight", 2 * F, r)
        normal(f"model.layers.{lid}.linear.weight", D, D)
    ones("model.final_layernorm.weight", D)
    return out


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _round(x, act):
    """x rounded to ``act`` and back (x itself where ``act`` is None)."""
    return x if act is None else x.to(act).to(x.dtype)


def _mm(x, w, acc=None, act=None):
    """x @ w.T (w in the published [out, in] layout); with ``acc`` bf16 the
    inputs are rounded to bf16 and the sum runs in bf16, ``ACC_BLOCK`` terms
    at a time; with ``act`` bf16 the inputs and the output are rounded to
    bf16 and the sum runs in x's dtype."""
    if act is not None:
        return _round(_round(x, act) @ _round(w, act).T, act)
    if acc is None or acc == x.dtype:
        return x @ w.T
    xr, wr = x.to(acc).to(x.dtype), w.to(acc).to(x.dtype)
    y = torch.zeros((*x.shape[:-1], w.shape[0]), dtype=acc, device=x.device)
    for k0 in range(0, x.shape[-1], ACC_BLOCK):
        y = (y.to(x.dtype) + xr[..., k0: k0 + ACC_BLOCK] @ wr[:, k0: k0 + ACC_BLOCK].T).to(acc)
    return y.to(x.dtype)


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """x [B, heads, S, hd]: RoPE over the whole head, halves rotated."""
    hd, S = x.shape[-1], x.shape[-2]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _attention(u, w, conf, d, acc, act, taps=None, head_block=8):
    """MHA over u; ``taps`` (a list) gets (K, V), each [B, S, heads, hd]
    after RoPE, the layout of a KV cache."""
    B, S, _ = u.shape
    heads, hd = d["heads"], d["hd"]
    q = _mm(u, w["q"], acc, act).view(B, S, heads, hd).transpose(1, 2)
    k = _mm(u, w["k"], acc, act).view(B, S, heads, hd).transpose(1, 2)
    v = _mm(u, w["v"], acc, act).view(B, S, heads, hd).transpose(1, 2)
    q = _round(_rope(q, conf["rope_theta"]), act)
    k = _round(_rope(k, conf["rope_theta"]), act)
    if taps is not None:
        taps.append((k.transpose(1, 2), v.transpose(1, 2)))
    scale = (hd / 2) ** -0.5
    future = torch.ones((S, S), dtype=torch.bool, device=u.device).triu(1)
    outs = []
    for h0 in range(0, heads, head_block):
        s = (q[:, h0: h0 + head_block] @ k[:, h0: h0 + head_block].transpose(-1, -2)) * scale
        s = s.masked_fill(future, -math.inf)
        outs.append(_round(torch.softmax(s, dim=-1), act) @ v[:, h0: h0 + head_block])
    o = torch.cat(outs, dim=1).transpose(1, 2).reshape(B, S, heads * hd)
    return _mm(o, w["o"], acc, act)


def _ssd_recurrence(x, dt, A, Bg, Cg, acc, act=None):
    """x [B, S, H, P], dt [B, S, H], Bg, Cg [B, S, H, N] (per head) ->
    (y [B, S, H, P], the final state [B, H, N, P]); the state held in
    ``acc``."""
    Bsz, S, H, P = x.shape
    st = torch.zeros((Bsz, H, P, Bg.shape[-1]), dtype=acc, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A)[:, :, None, None]
        upd = (dt[:, t, :, None, None] * x[:, t, :, :, None]) * Bg[:, t, :, None, :]
        st = (st.to(x.dtype) * dA + upd).to(acc)
        ys.append(torch.einsum("bhpn,bhn->bhp", st.to(x.dtype), Cg[:, t]))
    return torch.stack(ys, dim=1), st.to(x.dtype).transpose(-1, -2)


def _sum_blocks(a, b, acc, dtype, block):
    """a @ b over the contracted dim, in ``dtype``; with ``acc`` another
    dtype, accumulated in ``acc`` a block of ``block`` terms at a time."""
    if acc == dtype:
        return a @ b
    y = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=acc, device=a.device)
    for k0 in range(0, a.shape[-1], block):
        y = (y.to(dtype) + a[..., k0: k0 + block] @ b[..., k0: k0 + block, :]).to(acc)
    return y.to(dtype)


def _ssd_quadratic(x, dt, A, Bg, Cg, acc, act=None, head_block=16, key_block=64):
    """The whole sequence's quadratic form, batch by batch and heads in
    blocks, and the final state S_T = sum_t exp(sum_{t<u<=T} dt_u A) dt_t
    B_t x_t^T; with ``acc`` bf16 the sums over keys (and over t) are
    accumulated in bf16, a block of ``key_block`` at a time; with ``act``
    bf16 the form's operands (the decay mask, C B^T, dt x) are rounded to
    it.  Returns (y [B, S, H, P], S_T [B, H, N, P])."""
    Bsz, S, H, P = x.shape
    ys = torch.empty_like(x)
    fin = torch.empty((Bsz, H, Bg.shape[-1], P), dtype=x.dtype, device=x.device)
    future = torch.ones((S, S), dtype=torch.bool, device=x.device).triu(1)
    for b in range(Bsz):
        xw = _round((x[b] * dt[b][..., None]).transpose(0, 1), act)  # [H, S, P]
        cs = torch.cumsum((dt[b] * A).to(torch.float64), dim=0).T  # [H, S]
        for h0 in range(0, H, head_block):
            hs = slice(h0, min(h0 + head_block, H))
            to_end = torch.exp(cs[hs, -1:] - cs[hs]).to(x.dtype)  # [h, S]
            bt = Bg[b, :, hs].transpose(0, 1)  # [h, S, N]
            fin[b, hs] = _sum_blocks((bt * to_end[..., None]).transpose(-1, -2), xw[hs],
                                     acc, x.dtype, key_block)
            seg = (cs[hs, :, None] - cs[hs, None, :]).masked_fill_(future, -math.inf)
            m = _round(torch.exp(seg).to(x.dtype), act)
            del seg
            cb = _round(Cg[b, :, hs].transpose(0, 1) @ bt.transpose(-1, -2), act)
            m.mul_(cb)
            del cb
            ys[b, :, hs] = _sum_blocks(m, xw[hs], acc, x.dtype, key_block).transpose(0, 1)
            del m
    return ys, fin


def _mamba(u, w, conf, d, ssd, acc, act, eps):
    """The mamba mixer over u -> (its output, the final SSM state [B, H, N,
    P])."""
    mm_acc = None if acc == u.dtype else acc
    Bsz, S, _ = u.shape
    Di, H, P, G, N, K = d["Di"], d["H"], d["P"], d["G"], d["N"], d["K"]
    proj = _mm(u, w["in_proj"], mm_acc, act)
    z, xbc, dt = proj.split([Di, d["conv"], H], dim=-1)
    cw = w["conv_w"][:, 0, :]  # [conv, K]
    pad = torch.nn.functional.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(pad[:, k: k + S] * cw[:, k] for k in range(K)) + w["conv_b"]
    xbc = _round(torch.nn.functional.silu(conv), act)
    x, Bm, Cm = xbc.split([Di, G * N, G * N], dim=-1)
    dt = torch.nn.functional.softplus(dt + w["dt_bias"]).clamp(min=conf["time_step_min"])
    A = -torch.exp(w["A_log"])
    x = x.reshape(Bsz, S, H, P)
    rep = H // G
    Bg = Bm.reshape(Bsz, S, G, N).repeat_interleave(rep, dim=2)
    Cg = Cm.reshape(Bsz, S, G, N).repeat_interleave(rep, dim=2)
    run = _ssd_recurrence if ssd == "recurrence" else _ssd_quadratic
    y, fin = run(x, dt, A, Bg, Cg, acc, act)
    y = _round(y + w["D"][:, None] * x, act)
    y = y.reshape(Bsz, S, Di) * torch.nn.functional.silu(z)
    yg = y.view(Bsz, S, G, Di // G)
    yg = yg * torch.rsqrt((yg * yg).mean(-1, keepdim=True) + eps)
    y = _round(yg.reshape(Bsz, S, Di), act) * w["norm"]
    return _mm(y, w["out_proj"], mm_acc, act), fin


@contextlib.contextmanager
def _no_tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def forward(state: dict, conf: dict, tokens: torch.Tensor, *, dtype=torch.float32,
            ssd: str = "recurrence", acc: Optional[torch.dtype] = None,
            act: Optional[torch.dtype] = None, device=None,
            taps: Optional[dict] = None) -> torch.Tensor:
    """Logits [B, S, vocab] in ``dtype`` of ``tokens`` [B, S] (positions
    0..S-1), on ``device`` (default: the tokens'); ``acc`` bf16 is the
    control, ``act`` bf16 the configuration's precision.  ``taps`` (a dict)
    gets 'k' and 'v', each application's K and V [B, S, heads, hd] after
    RoPE (as a KV cache holds them), and 'S', each layer's final SSM state
    [B, H, N, P] (as the SSM cache holds it)."""
    device = tokens.device if device is None else torch.device(device)
    ssd_acc = dtype if acc is None else acc
    d = dims(conf)
    eps = conf["rms_norm_eps"]
    ids = hybrid_ids(conf)
    nmem = conf["num_mem_blocks"]

    def get(name):
        return state[name].to(device=device, dtype=dtype)

    kv = [] if taps is not None else None
    states = []
    r = lambda x: _round(x, act)  # noqa: E731
    with torch.inference_mode(), _no_tf32():
        tokens = tokens.to(device)
        emb = get("model.embed_tokens.weight")
        x0 = emb[tokens]
        h = x0
        for i in range(conf["num_hidden_layers"]):
            u = h
            if i in ids:
                a = ids.index(i)
                st = f"model.layers.{ids[a % nmem]}.shared_transformer."
                ad = st + f"feed_forward.gate_up_proj_adapter_list.{a}."
                t = r(_rms(torch.cat([h, x0], dim=-1), get(st + "input_layernorm.weight"),
                           eps))
                t = _attention(t, {n: get(st + f"self_attn.{n}_proj.weight")
                                   for n in ("q", "k", "v", "o")}, conf, d, acc, act, kv)
                t = r(_rms(t, get(st + "pre_ff_layernorm.weight"), eps))
                gu = r(_mm(t, get(st + "feed_forward.gate_up_proj.weight"), acc, act)
                       + _mm(_mm(t, get(ad + "0.weight"), acc, act), get(ad + "1.weight"),
                             acc, act))
                gate, up = gu.chunk(2, dim=-1)
                t = _mm(torch.nn.functional.gelu(gate) * up,
                        get(st + "feed_forward.down_proj.weight"), acc, act)
                u = r(h + _mm(t, get(f"model.layers.{i}.linear.weight"), acc, act))
            pre = f"model.layers.{i}." + ("mamba_decoder." if i in ids else "")
            m = pre + "mamba."
            w = {"in_proj": get(m + "in_proj.weight"), "out_proj": get(m + "out_proj.weight"),
                 "conv_w": get(m + "conv1d.weight"), "conv_b": get(m + "conv1d.bias"),
                 "dt_bias": get(m + "dt_bias"), "A_log": get(m + "A_log"), "D": get(m + "D"),
                 "norm": get(m + "norm.weight")}
            y, fin = _mamba(r(_rms(u, get(pre + "input_layernorm.weight"), eps)), w, conf,
                            d, ssd, ssd_acc, act, eps)
            h = r(h + y)
            if acc is not None:  # the residual stream's sums too
                h = h.to(acc).to(dtype)
            if taps is not None:
                states.append(fin)
            del w
        if taps is not None:
            taps.update(k=[k for k, _ in kv], v=[v for _, v in kv], S=states)
        h = r(_rms(h, get("model.final_layernorm.weight"), eps))
        return _mm(h, emb, acc, act)
