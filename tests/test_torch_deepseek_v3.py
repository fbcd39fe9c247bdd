"""DeepSeek-V3's block as published (``kanana-2-30b-a3b-instruct``, a
port-only id): the port against its plain reference
(``nspubench/reference/deepseek_v3.py``) at a small size of the published
layout on the CPU in float64, the reference against ``transformers``'
``DeepseekV3ForCausalLM`` on the same state dict, the absorbed decode
against the expanded form, the sigmoid router, the row-at-a-time prefill
and ``serve``'s choice of prefill positions.

The smoke config has 3 layers (one dense), 2 heads at the published head
widths (q and k 128 + 64, v 128), a latent of 32 + 64, 8 experts top 3
and one shared expert.  Weights are drawn by the published init rule (the
router's bias N(0, 0.05^2)) and then made non-trivial (norms away from 1,
projections 10x the init's 0.02), so every term of the layer equations
moves the logits.
"""
from __future__ import annotations

import dataclasses
import math
import os

import pytest
import torch

from nspubench.reference import deepseek_v3 as R
from repro_torch import configs, obs
from repro_torch.kernels import flash_attention as flash_lib
from repro_torch.launch import serve as serve_lib
from repro_torch.models import deepseek_v3, layers, moe
from repro_torch.models import transformer as T

ARCH = "kanana-2-30b-a3b-instruct"


def _cfg():
    return configs.get_arch(ARCH, smoke=True)


def _state(cfg, seed=7):
    conf = deepseek_v3.hf_config(cfg)
    state = R.init_state(conf, seed, "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in state.items():
        if "norm" in k:
            state[k] = v + 0.3 * torch.randn(v.shape, generator=g)
        elif v.dim() >= 2 and "embed" not in k:
            state[k] = v * 10
    return conf, state


def _f64(state):
    return {k: v.double() for k, v in state.items()}


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def case():
    cfg = _cfg()
    conf, state = _state(cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(3))
    taps = {}
    ref = R.forward(_f64(state), conf, tok, dtype=torch.float64, taps=taps, q_block=7)
    model = T.params_from_hf(state, cfg, "cpu").double()
    return cfg, conf, state, tok, ref, taps, model


def test_config_is_the_published_one_and_a_port_only_id():
    cfg = configs.get_arch(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.qk_head_dim, cfg.v_head_dim) == (
        48, 2048, 32, 192, 128)
    assert (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.latent_dim, cfg.first_k_dense) == (
        512, 64, 576, 1)
    assert (cfg.n_experts, cfg.top_k, cfg.moe_d_ff, cfg.shared_d_ff, cfg.d_ff) == (
        128, 6, 768, 1536, 6144)
    assert (cfg.vocab_size, cfg.norm_eps, cfg.tie_embeddings, cfg.rope_theta) == (
        128256, 1e-6, False, 1e6)
    assert cfg.routed_scaling == 2.448 and cfg.max_position == 32768
    # 30.67 B parameters, 57.1 GiB in bf16
    assert cfg.param_count() == 30_670_815_104
    assert ARCH in configs.PORT_ONLY and ARCH not in configs.ARCH_IDS
    assert deepseek_v3.config_from_hf(deepseek_v3.hf_config(cfg), ARCH) == cfg


def test_config_from_hf_refuses_what_the_port_does_not_run():
    conf = deepseek_v3.hf_config(configs.get_arch(ARCH))
    for key, value in (("q_lora_rank", 1536), ("rope_interleave", False),
                       ("scoring_func", "softmax"), ("n_group", 8), ("topk_group", 4),
                       ("tie_word_embeddings", True), ("attention_bias", True),
                       ("rope_scaling", {"type": "yarn", "factor": 4.0}),
                       ("num_key_value_heads", 8)):
        with pytest.raises(ValueError):
            deepseek_v3.config_from_hf(dict(conf, **{key: value}))


def test_one_place_dispatches_the_published_layouts():
    assert T.published(configs.get_arch(ARCH)) is deepseek_v3
    with pytest.raises(ValueError):
        T.params_from_hf({}, configs.get_arch("olmoe-1b-7b", smoke=True))


def test_the_reference_matches_transformers_on_the_published_names(case):
    """``transformers``' model loads the reference's state dict under its
    own names (the bias a buffer); its logits match the reference's within
    f32 (its router and MoE sum run in f32 whatever the model's dtype, so
    it runs in f32 here: the reference's own f32 rounding is ~2e-6)."""
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    cfg, conf, state, tok, ref, _, _ = case
    tcfg = transformers.DeepseekV3Config(**{k: v for k, v in conf.items()
                                            if k != "model_type"})
    tcfg._attn_implementation = "eager"
    hf = transformers.DeepseekV3ForCausalLM(tcfg).float().eval()
    res = hf.load_state_dict(state, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    with torch.no_grad():
        out = hf(tok).logits
    assert _rel(out, ref) < 1e-5


def test_pair_rope_gives_transformers_interleaved_rope_scores():
    """RoPE on the pairs (2i, 2i + 1) in place (the program's and the
    reference's) against ``apply_rotary_pos_emb_interleave`` (a permutation
    to halves, then ``rotate_half``): the same q . k at every pair of
    positions, and the same values up to that permutation."""
    os.environ.setdefault("USE_TF", "0")
    pytest.importorskip("transformers")
    from transformers.models.deepseek_v3 import modeling_deepseek_v3 as M

    g = torch.Generator().manual_seed(0)
    B, S, H, d, theta = 1, 9, 3, 64, 1e6
    q = torch.randn((B, S, H, d), generator=g, dtype=torch.float64)
    k = torch.randn((B, S, 1, d), generator=g, dtype=torch.float64)
    pos = torch.arange(S)[None]
    tables = layers.rope_half_tables(pos, d, theta, torch.float64)
    got_q, got_k = (deepseek_v3.apply_rope_pairs(t, tables) for t in (q, k))
    cos, sin = R.rope_tables(S, d, theta, torch.float64, "cpu")
    assert torch.allclose(R.rope_pairs(q, cos, sin), got_q, atol=1e-12)
    emb = torch.cat([tables[0][0, :, 0], tables[0][0, :, 0]], -1)[None]
    emb_s = torch.cat([tables[1][0, :, 0], tables[1][0, :, 0]], -1)[None]
    hf_q, hf_k = M.apply_rotary_pos_emb_interleave(q.transpose(1, 2), k.transpose(1, 2),
                                                  emb, emb_s)
    perm = torch.cat([torch.arange(0, d, 2), torch.arange(1, d, 2)])
    assert torch.allclose(got_q[..., perm], hf_q.transpose(1, 2), atol=1e-12)
    assert torch.allclose(got_k[..., perm], hf_k.transpose(1, 2), atol=1e-12)
    scores = torch.einsum("bqhd,bkd->bhqk", got_q, got_k[:, :, 0])
    hf_scores = torch.einsum("bhqd,bkd->bhqk", hf_q, hf_k[:, 0])
    assert torch.allclose(scores, hf_scores, atol=1e-12)
    # RoPE on halves (the other layout) is another rotation
    halves = layers.apply_rope_half(q, tables)
    assert not torch.allclose(halves, got_q, atol=1e-3)


def test_forward_matches_the_reference(case):
    cfg, _, _, tok, ref, _, model = case
    with torch.inference_mode():
        got = T.forward(model, tok)[..., : cfg.vocab_size]
    assert _rel(got, ref) < 1e-10


def test_prefill_then_decode_through_the_latent_cache_matches_the_full_forward(case):
    """A cached prefill of 32 positions (a row at a time), then eight
    decode steps on the absorbed form, each against the reference's full
    forward; the cache holds the reference's latent rows (c after its
    norm, k_pe after RoPE) and no per-head K or V."""
    cfg, _, _, tok, ref, taps, model = case
    with torch.inference_mode():
        cache, lp = T.prefill(model, tok[:, :32], max_len=41)
        assert _rel(lp[..., : cfg.vocab_size], ref[:, :32]) < 1e-10
        for s in range(32, 40):
            cache, lg = T.decode_step(model, cache, tok[:, s: s + 1])
            assert _rel(lg[:, 0, : cfg.vocab_size], ref[:, s]) < 1e-10, s
    assert set(cache) == {"latent", "route", "moe", "len"}
    assert cache["latent"].shape == (cfg.n_layers, 2, 64, cfg.latent_dim)  # 41 rows aligned
    for got, want in zip(cache["latent"], taps["latent"]):
        assert _rel(got[:, :40], want) < 1e-10


def test_the_absorbed_decode_equals_the_expanded_form(case):
    """One MLA block: the decode step's absorbed form over the latent cache
    ([q_nope W_k^T, q_pe] against [c, k_pe], c the value, then W_v) against
    the expanded form's last row over the same positions, at several
    positions, with rows past the position holding garbage."""
    cfg, _, _, tok, _, _, model = case
    blk = model.blocks[1]
    g = torch.Generator().manual_seed(5)
    u = torch.randn((2, 30, cfg.d_model), generator=g, dtype=torch.float64)
    with torch.inference_mode():
        for n in (1, 7, 30):
            pos = torch.arange(n)[None].expand(2, n)
            rope = layers.rope_half_tables(pos, cfg.qk_rope_dim, cfg.rope_theta, u.dtype)
            want = deepseek_v3._mla(blk, u[:, :n], cfg, rope, 1, None, None)[:, -1]
            lat = torch.full((2, 31, cfg.latent_dim), 1e3, dtype=u.dtype)
            if n > 1:  # the prompt's rows, by a prefill
                deepseek_v3._mla(blk, u[:, : n - 1], cfg,
                                 tuple(t[:, : n - 1] for t in rope), 1, lat, None)
            at = torch.tensor([n - 1])
            rope1 = tuple(t[:, n - 1: n] for t in rope)
            got = deepseek_v3._mla(blk, u[:, n - 1: n], cfg, rope1, 1, lat, at)[:, 0]
            assert _rel(got, want) < 1e-12, n


def test_the_router_chooses_by_score_plus_bias_and_gates_by_score():
    """``route_sigmoid``: the top k of sigmoid(logits) + bias (the lower id
    first on ties), the gates the chosen experts' unbiased scores over
    their sum (+ 1e-20) times the scaling; a bias that lifts a weak expert
    changes the choice but not its gate's score."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((6, 16), generator=g, dtype=torch.float64)
    router = torch.randn((16, 8), generator=g, dtype=torch.float64)
    bias = torch.zeros(8, dtype=torch.float64)
    bias[3] = 5.0  # expert 3 is always chosen
    gates, ids, scores = moe.route_sigmoid(x, router, bias, 3, 2.448)
    want_scores = torch.sigmoid(x @ router)
    assert torch.equal(scores, want_scores)
    for t in range(6):
        order = sorted(range(8), key=lambda e: (-(want_scores[t, e] + bias[e]), e))[:3]
        assert ids[t].tolist() == order
        s = want_scores[t, order]
        assert torch.allclose(gates[t], s / (s.sum() + 1e-20) * 2.448, rtol=1e-14)
    assert (ids == 3).any(dim=1).all()
    assert torch.allclose(gates.sum(dim=1), torch.full((6,), 2.448, dtype=torch.float64))
    # ties: equal scores + bias give the lower id first
    gates, ids, _ = moe.route_sigmoid(torch.zeros((2, 16), dtype=torch.float64), router,
                                      torch.zeros(8, dtype=torch.float64), 3, 1.0)
    assert ids.tolist() == [[0, 1, 2], [0, 1, 2]] and torch.allclose(gates, torch.full(
        (2, 3), 1 / 3, dtype=torch.float64))


def test_a_row_at_a_time_prefill_equals_a_whole_batch_one(case):
    """The cached prefill runs a row at a time; the forward (no cache) runs
    the whole batch at once: the same logits, and each row's latent rows
    are the row's own prefill's."""
    cfg, _, _, tok, _, _, model = case
    with torch.inference_mode():
        whole = T.forward(model, tok[:, :25])
        cache, rows = T.prefill(model, tok[:, :25], max_len=26)
        one, _ = T.prefill(model, tok[1:, :25], max_len=26)
    assert _rel(rows, whole) < 1e-12
    assert torch.equal(cache["latent"][:, 1:], one["latent"])


@pytest.mark.parametrize("skewed", [False, True], ids=["as_drawn", "one_expert_hot"])
def test_the_grouped_experts_equal_the_slots(skewed):
    """``moe.experts_grouped`` (each expert over its own rows, the prefill's
    form here) against ``experts_in_slots`` at the largest load (the
    slots' form), on the sigmoid router's routing, with and without one
    expert taking most tokens: the same outputs in float64 (its loop), and
    within bf16 rounding in bf16 (its grouped products)."""
    cfg = _cfg()
    g = torch.Generator().manual_seed(9)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    x = torch.randn((50, D), generator=g, dtype=torch.float64)
    p = {"router": torch.randn((D, E), generator=g, dtype=torch.float64) * 0.1,
         "bias": torch.zeros(E, dtype=torch.float64),
         "w_in": torch.randn((E, 2 * F, D), generator=g, dtype=torch.float64) * 0.1,
         "w_out": torch.randn((E, D, F), generator=g, dtype=torch.float64) * 0.1}
    if skewed:
        p["bias"][5] = 10.0
    gates, ids, _ = moe.route_sigmoid(x, p["router"], p["bias"], cfg.top_k, 2.448)
    loads = moe.expert_loads(ids, E).tolist()
    assert (max(loads) == 50) == skewed
    want = moe.experts_in_slots(x, p, gates, ids, max(loads))
    assert _rel(moe.experts_grouped(x, p, gates, ids), want) < 1e-12  # the loop
    # bf16: the grouped products over the experts' row offsets
    xb, pb = x.bfloat16(), {n: t.bfloat16() for n, t in p.items()}
    want = moe.experts_in_slots(xb, pb, gates, ids, max(loads))
    got = moe.experts_grouped(xb, pb, gates, ids)
    assert got.dtype == torch.bfloat16 and _rel(got.double(), want.double()) < 2e-2
    ref = moe.experts_grouped(x, {n: t.bfloat16().double() for n, t in p.items()}, gates, ids)
    assert _rel(got.double(), ref) < 2e-2


def test_serve_keeps_every_prompt_position_by_default_and_the_chosen_ones_on_request(case):
    """``serve``'s default returns the prefill's logits at every prompt
    position, as before; ``prefill_at`` returns the same values at the
    chosen positions only, the same tokens, and the kept rows' latent rows
    at those positions and the decode steps' (the reference's)."""
    cfg, conf, state, tok, _, _, model = case
    prompts = tok[:, :30]
    full = serve_lib.serve(cfg, tokens=4, device="cpu", model=model, prompts=prompts,
                           keep=[1])
    assert full.prefill_logits.shape == (2, 30, cfg.vocab_padded)
    at = [0, 11, 29]
    part = serve_lib.serve(cfg, tokens=4, device="cpu", model=model, prompts=prompts,
                           keep=[1], prefill_at=at)
    assert part.prefill_logits.shape == (2, 3, cfg.vocab_padded)
    assert _rel(part.prefill_logits, full.prefill_logits[:, at]) < 1e-12
    assert (part.generations == full.generations).all()
    assert _rel(part.step_logits, full.step_logits) < 1e-12
    lat = part.kept_cache["latent"]
    assert lat.shape == (cfg.n_layers, 1, 3 + 3, cfg.latent_dim)
    seq = torch.cat([prompts[1:], torch.from_numpy(full.generations[1:, :3])], dim=1)
    taps = {}
    R.forward(_f64(state), conf, seq, dtype=torch.float64, taps=taps,
              at=torch.tensor(at + [30, 31, 32]))
    for got, want in zip(lat, taps["latent"]):
        assert _rel(got[0], want[0]) < 1e-10
    assert part.kept_taps["moe"].shape == (1, cfg.n_moe, 3, cfg.d_model)
    for got, want in zip(part.kept_taps["moe"][0], taps["moe"]):
        assert _rel(got, want[0, :3]) < 1e-10
    assert full.kept_taps["moe"].shape == (1, cfg.n_moe, 30, cfg.d_model)
    for got, want in zip(part.kept_taps["moe_decode"][0], taps["moe"]):
        assert _rel(got, want[0, 3:]) < 1e-10
    # each MoE block's chosen experts at every prompt position and decode
    # step, the reference's own choice (float64 on both sides)
    route = torch.cat([part.kept_taps["route"][0],
                       part.kept_taps["route_decode"][0].to(torch.int16)], dim=1)
    assert route.shape == (cfg.n_moe, 30 + 3, cfg.top_k)
    for got, want in zip(route, taps["route"]):
        assert torch.equal(got.long(), want[0])


def test_the_reference_forced_to_a_routing_takes_it_and_counts_its_own_other_choices(case):
    """``forward(route=...)``: each MoE block takes the given experts, its
    gates those experts' unbiased scores normalised and scaled; forced to
    its own choice it reads as unforced, with no token choosing otherwise;
    forced to another choice its logits move and it counts the tokens whose
    own choice differs."""
    cfg, conf, state, tok, ref, _, _ = case
    own = {}
    base = R.forward(_f64(state), conf, tok, dtype=torch.float64, taps=own)
    same = {}
    lg = R.forward(_f64(state), conf, tok, dtype=torch.float64, taps=same, route=own["route"])
    assert torch.equal(lg, base) and same["route_differ"] == [0] * cfg.n_moe
    # the last token's choice in every block swapped for the experts it
    # ranked below
    other = [r.clone() for r in own["route"]]
    for r in other:
        r[:, -1] = torch.tensor([e for e in range(cfg.n_experts)
                                 if e not in r[0, -1].tolist()][: cfg.top_k])
    moved = {}
    lg = R.forward(_f64(state), conf, tok, dtype=torch.float64, taps=moved, route=other)
    assert moved["route_differ"] == [tok.shape[0]] * cfg.n_moe  # the batch's last tokens
    assert _rel(lg[:, :-1], base[:, :-1]) < 1e-12 and _rel(lg[:, -1], base[:, -1]) > 1e-3
    assert all(torch.equal(a, b) for a, b in zip(moved["route"], other))


def test_the_loader_round_trips_the_published_names(case):
    """Every published tensor comes back out of the port's model, in the
    published layout: ``kv_b_proj`` from its per-head K and V rows, each
    expert's gate, up and down from the stacked w_in and w_out."""
    cfg, conf, state, _, _, _, _ = case
    model = T.params_from_hf(state, cfg, "cpu")
    back = {"model.embed_tokens.weight": model.embed[: cfg.vocab_size],
            "lm_head.weight": model.lm_head[:, : cfg.vocab_size].t(),
            "model.norm.weight": model.final_norm.gamma}
    F = cfg.moe_d_ff
    for i, blk in enumerate(model.blocks):
        pre, a, m = f"model.layers.{i}.", f"model.layers.{i}.self_attn.", f"model.layers.{i}.mlp."
        p = blk.mla.params()
        back.update({
            pre + "input_layernorm.weight": blk.norm1.gamma,
            pre + "post_attention_layernorm.weight": blk.norm2.gamma,
            a + "q_proj.weight": p["wq"].t(), a + "kv_a_proj_with_mqa.weight": p["wkv_a"].t(),
            a + "kv_a_layernorm.weight": p["kv_norm"], a + "o_proj.weight": p["wo"].t(),
            a + "kv_b_proj.weight": torch.cat([p["wk_b"], p["wv_b"]], 1).reshape(
                -1, cfg.kv_lora_rank)})

        def swiglu(pre, w):
            f = w["w_out"].shape[0]
            return {pre + "gate_proj.weight": w["w_in"][:, :f].t(),
                    pre + "up_proj.weight": w["w_in"][:, f:].t(),
                    pre + "down_proj.weight": w["w_out"].t()}

        if i < cfg.first_k_dense:
            back.update(swiglu(m, blk.dense.params()))
            continue
        mp = blk.moe.params()
        back.update({m + "gate.weight": mp["router"].t(),
                     m + "gate.e_score_correction_bias": mp["bias"]})
        for e in range(cfg.n_experts):
            x = m + f"experts.{e}."
            back.update({x + "gate_proj.weight": mp["w_in"][e, :F],
                         x + "up_proj.weight": mp["w_in"][e, F:],
                         x + "down_proj.weight": mp["w_out"][e]})
        back.update(swiglu(m + "shared_experts.", blk.shared.params()))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    assert set(state) == set(R.LazyState(conf, 7, "cpu", torch.float32))


def test_the_lazy_state_draws_each_tensor_from_its_own_generator():
    cfg = _cfg()
    conf = deepseek_v3.hf_config(cfg)
    lazy = R.LazyState(conf, 11, "cpu", torch.float32)
    name = "model.layers.1.mlp.experts.3.up_proj.weight"
    assert torch.equal(lazy[name], lazy[name])
    assert not torch.equal(lazy[name], R.LazyState(conf, 12, "cpu", torch.float32)[name])
    bias = lazy["model.layers.1.mlp.gate.e_score_correction_bias"]
    assert bias.dtype == torch.float32 and 0.01 < float(bias.std()) < 0.2
    w = lazy["model.layers.0.self_attn.q_proj.weight"]
    assert abs(float(w.std()) - 0.02) < 0.002
    assert torch.equal(lazy["model.layers.0.self_attn.kv_a_layernorm.weight"],
                       torch.ones(cfg.kv_lora_rank))


def test_decode_with_its_position_on_the_device_leaves_len_unread(case):
    """``decode_static`` at a device position (the step the decode graph
    captures) equals ``decode_step`` at 'len', and writes each MoE layer's
    routing into the cache's buffer."""
    cfg, _, _, tok, _, _, model = case
    with torch.inference_mode():
        c1, _ = T.prefill(model, tok[:, :30], max_len=36)
        c2, _ = T.prefill(model, tok[:, :30], max_len=36)
        _, want = T.decode_step(model, c1, tok[:, 30:31])
        got = deepseek_v3.decode_static(model, dict(c2, len=None), tok[:, 30:31],
                                        torch.tensor([30]))
    assert torch.equal(got, want)
    assert torch.equal(c1["latent"], c2["latent"])
    assert torch.equal(c1["route"], c2["route"]) and c2["route"].shape == (2, 2, cfg.top_k)


def test_traced_serving_records_the_mla_spans_and_counters(case):
    """Each MLA block outside the decode graph is an ``lm.mla`` span; the
    counters give the blocks, the causal pairs the prefill's heads score
    and the latent bytes written; the MoE's spans and counters as
    Granite's."""
    cfg, _, _, tok, _, _, model = case
    obs.reset()
    obs.enable()
    try:
        serve_lib.serve(cfg, tokens=3, device="cpu", model=model, prompts=tok[:, :20])
    finally:
        obs.disable()
    snap = obs.snapshot()
    obs.reset()
    mla = [s for s in snap["spans"] if s[0] == "lm.mla"]
    L = cfg.n_layers
    assert len(mla) == 2 * L + 2 * L  # a row at a time, then 2 eager decode steps
    assert [s[4][1] for s in mla] == ["prefill"] * 2 * L + ["decode"] * 2 * L
    assert [s[4][2] for s in mla[:L]] == [20] * L
    c = snap["counters"]
    assert c["lm.mla_blocks"] == 4 * L
    assert c["lm.mla_pairs"] == 2 * L * cfg.n_heads * 20 * 21 // 2
    assert c["lm.mla_latent_bytes"] == L * (2 * 20 + 2 * 2) * cfg.latent_dim * 8
    assert c["lm.moe_blocks"] == 2 * cfg.n_moe + 2 * cfg.n_moe
    assert len([s for s in snap["spans"] if s[0] == "lm.moe"]) == 4 * cfg.n_moe


def test_the_flash_wrapper_takes_mla_head_dims_on_the_cpu():
    """Q and K at 192, V at 128 (``SPLIT_DIMS``): the plain version gives
    [B, Sq, Hq, 128], the attention of the 128 columns of V by the scores
    of the 192 of Q and K; other unequal dims are refused by the kernel's
    checks."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn((1, 20, 2, 192), generator=g)
    k = torch.randn((1, 20, 2, 192), generator=g)
    v = torch.randn((1, 20, 2, 128), generator=g)
    got = flash_lib.flash_attention(q, k, v, True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(192)
    s = s.masked_fill(torch.ones(20, 20, dtype=torch.bool).triu(1), -math.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    assert got.shape == (1, 20, 2, 128) and _rel(got, want) < 1e-5
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA"):
        flash_lib._check_cuda(*meta)
    assert (192, 128) in flash_lib.SPLIT_DIMS


def test_the_bias_and_the_scaling_reach_the_logits(case):
    """The routed scaling and the router's bias each move the logits (a
    config or a state without them does not match the reference)."""
    cfg, _, state, tok, ref, _, _ = case
    other = T.params_from_hf(state, dataclasses.replace(cfg, routed_scaling=1.0),
                             "cpu").double()
    no_bias = dict(state)
    for k in state:
        if k.endswith("e_score_correction_bias"):
            no_bias[k] = torch.zeros_like(state[k])
    for model in (other, T.params_from_hf(no_bias, cfg, "cpu").double()):
        with torch.inference_mode():
            got = T.forward(model, tok)[..., : cfg.vocab_size]
        assert _rel(got, ref) > 1e-4


def test_launcher_serves_the_new_arch_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch

    assert launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "20", "--tokens", "3"]) == 0
    assert "[serve] kanana-2-30b-a3b-instruct-smoke" in capsys.readouterr().out
