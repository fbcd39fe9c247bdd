"""Granite 4.0-H as published (``granite-4.0-h-small``, a port-only id): the
port against its plain reference (``nspubench/reference/granite4h.py``)
at a small size of the published layout on the CPU in float64, the
reference against ``transformers``' ``GraniteMoeHybridForCausalLM`` on the
same state dict, and the dropless MoE where the capacity path drops.

The smoke config has 4 layers with attention at id 2 (GQA 4:2), 8
experts top 3 and chunk 16; prompts span three chunks.  Weights are drawn
by the published init rule and then made non-trivial (norms, conv biases
and D away from 1 and 0, projections 10x the init's 0.02, A and dt_bias
so that the SSM carries its state across chunks), so every term of the
layer equations moves the logits.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib

import numpy as np
import pytest
import torch

from nspubench import granite_faults
from nspubench.reference import granite4h as R
from repro_torch import configs, obs
from repro_torch.launch import serve as serve_lib
from repro_torch.models import granite4h, moe, zamba2
from repro_torch.models import transformer as T

ARCH = "granite-4.0-h-small"
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cfg():
    return configs.get_arch(ARCH, smoke=True)


def _state(cfg, seed=7):
    conf = granite4h.hf_config(cfg)
    state = R.init_state(conf, seed, "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in state.items():
        if "norm" in k or k.endswith(("conv1d.bias", ".D")):
            state[k] = v + 0.3 * torch.randn(v.shape, generator=g)
        elif k.endswith("A_log"):
            state[k] = torch.log(torch.rand(v.shape, generator=g) * 0.1 + 1e-3)
        elif k.endswith("dt_bias"):
            state[k] = torch.full(v.shape, -3.0) + torch.randn(v.shape, generator=g)
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
    tok = torch.randint(0, cfg.vocab_size, (2, 45), generator=torch.Generator().manual_seed(3))
    taps = {}
    ref = R.forward(_f64(state), conf, tok, dtype=torch.float64, taps=taps)
    model = T.params_from_hf(state, cfg, "cpu").double()
    return cfg, conf, state, tok, ref, taps, model


def test_config_is_the_published_one_and_a_port_only_id():
    cfg = configs.get_arch(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim) == (
        40, 4096, 8192, 128, 64)
    assert (cfg.ssm_state, cfg.ssm_groups, cfg.ssm_chunk, cfg.conv_bias, cfg.dt_min) == (
        128, 1, 256, True, 0.0)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.attn_layer_ids) == (
        32, 8, 128, (5, 15, 25, 35))
    assert (cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.shared_d_ff) == (72, 10, 768, 1536)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier, cfg.logits_scaling,
            cfg.attention_multiplier) == (12.0, 0.22, 16.0, 1 / 128)
    assert (cfg.vocab_size, cfg.norm_eps, cfg.tie_embeddings) == (100352, 1e-5, True)
    assert cfg.param_count() == 32_207_337_984
    # top 10 of 72 experts, the shared expert and the router a token
    assert cfg.active_param_count() == 8_803_121_664
    assert cfg.model_flops_per_token() == 6 * 8_803_121_664
    assert ARCH in configs.PORT_ONLY and ARCH not in configs.ARCH_IDS
    # the benchmark's configuration file is the published config
    conf = json.loads((ROOT / "nspubench/configs/granite-4.0-h-small.json").read_text())
    assert granite4h.config_from_hf(conf, ARCH) == cfg
    smoke = _cfg()
    assert smoke.n_experts >= 8 and smoke.top_k > 1 and smoke.n_attn == 1 and smoke.n_mamba == 3
    for c in (cfg, smoke):
        back = granite4h.config_from_hf(dict(granite4h.hf_config(c),
                                             vocab_pad_to=c.vocab_pad_to), c.name, c.dtype)
        assert back == dataclasses.replace(c, kv_chunk=back.kv_chunk)


def test_config_from_hf_refuses_what_the_port_does_not_run():
    conf = granite4h.hf_config(configs.get_arch(ARCH))
    for key, value in (("position_embedding_type", "rope"), ("mamba_n_groups", 2),
                       ("tie_word_embeddings", False), ("attention_bias", True),
                       ("layer_types", ["mamba"] * 39 + ["moe"])):
        with pytest.raises(ValueError):
            granite4h.config_from_hf(dict(conf, **{key: value}))


def test_one_place_dispatches_the_published_layouts():
    assert T.published(configs.get_arch(ARCH)) is granite4h
    assert T.published(configs.get_arch("zamba2-7b-instruct")) is zamba2
    assert T.published(configs.get_arch("olmoe-1b-7b")) is None
    with pytest.raises(ValueError):
        T.params_from_hf({}, configs.get_arch("olmoe-1b-7b", smoke=True))


def test_forward_matches_the_reference(case):
    cfg, _, _, tok, ref, _, model = case
    with torch.inference_mode():
        got = T.forward(model, tok)[..., : cfg.vocab_size]
    assert _rel(got, ref) < 1e-10


def test_prefill_then_decode_through_the_caches_matches_the_full_forward(case):
    """A cached prefill of 40 positions (three chunks, the state carried),
    then five decode steps, each against the reference's full forward;
    the caches hold the reference's K, V and final SSM states."""
    cfg, _, _, tok, ref, taps, model = case
    with torch.inference_mode():
        cache, lp = T.prefill(model, tok[:, :40], max_len=46)
        assert _rel(lp[..., : cfg.vocab_size], ref[:, :40]) < 1e-10
        for s in range(40, 45):
            cache, lg = T.decode_step(model, cache, tok[:, s: s + 1])
            assert _rel(lg[:, 0, : cfg.vocab_size], ref[:, s]) < 1e-10, s
    # K and V of the attention layer and the mamba layers' final states
    # after all 45 positions
    assert _rel(cache["k"][0, :, :45], taps["k"][0]) < 1e-10
    assert _rel(cache["v"][0, :, :45], taps["v"][0]) < 1e-10
    assert len(cache["S"]) == len(taps["S"]) == 3
    for got, want in zip(cache["S"], taps["S"]):
        assert _rel(got, want) < 1e-10


def test_decode_with_its_position_on_the_device_leaves_len_unread(case):
    """``decode_static`` at a device position (the step the decode graph
    captures) equals ``decode_step`` at 'len', and writes each layer's
    routing into the cache's buffer."""
    cfg, _, _, tok, _, _, model = case
    with torch.inference_mode():
        c1, _ = T.prefill(model, tok[:, :40], max_len=46)
        c2, _ = T.prefill(model, tok[:, :40], max_len=46)
        _, want = T.decode_step(model, c1, tok[:, 40:41])
        got = granite4h.decode_static(model, dict(c2, len=None), tok[:, 40:41],
                                      torch.tensor([40]))
    assert torch.equal(got, want)
    assert torch.equal(c1["route"], c2["route"]) and c2["route"].shape == (4, 2, cfg.top_k)
    assert all(len(set(r)) == cfg.top_k for r in c2["route"].reshape(-1, cfg.top_k).tolist())


def test_the_loader_round_trips_the_published_names(case):
    """Every published tensor comes back out of the port's model, in the
    published layout; ``transformers``' model loads the same names (the
    head tied) and its logits match the reference's (its torch_forward
    runs the SSM in f32)."""
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    cfg, conf, state, tok, ref, _, _ = case
    model = T.params_from_hf(state, cfg, "cpu")
    back = {"model.embed_tokens.weight": model.embed[: cfg.vocab_size],
            "model.norm.weight": model.final_norm.gamma}
    for i, blk in enumerate(model.blocks):
        pre = f"model.layers.{i}."
        moe_p, sh = blk.moe.params(), blk.shared.params()
        back.update({
            pre + "input_layernorm.weight": blk.norm1.gamma,
            pre + "post_attention_layernorm.weight": blk.norm2.gamma,
            pre + "block_sparse_moe.router.layer.weight": moe_p["router"].t(),
            pre + "block_sparse_moe.input_linear.weight": moe_p["w_in"],
            pre + "block_sparse_moe.output_linear.weight": moe_p["w_out"],
            pre + "shared_mlp.input_linear.weight": sh["w_in"].t(),
            pre + "shared_mlp.output_linear.weight": sh["w_out"].t()})
        if i in cfg.attn_layer_ids:
            p = blk.attn.params()
            back.update({pre + f"self_attn.{n}_proj.weight": p[f"w{n}"].t() for n in "qkvo"})
        else:
            p, m = blk.ssm.params(), pre + "mamba."
            back.update({m + "in_proj.weight": p["in_proj"].t(),
                         m + "out_proj.weight": p["out_proj"].t(),
                         m + "conv1d.weight": p["conv_w"].t()[:, None, :],
                         m + "conv1d.bias": p["conv_b"], m + "dt_bias": p["dt_bias"],
                         m + "A_log": p["A_log"], m + "D": p["D_skip"],
                         m + "norm.weight": p["norm"]})
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    hc = {k: v for k, v in conf.items() if k != "model_type"}
    tcfg = transformers.GraniteMoeHybridConfig(**hc)
    tcfg._attn_implementation = "eager"
    hf = transformers.GraniteMoeHybridForCausalLM(tcfg).double().eval()
    res = hf.load_state_dict(_f64(state), strict=False)
    assert res.unexpected_keys == [] and res.missing_keys == ["lm_head.weight"]
    with torch.no_grad():
        out = hf(tok).logits
    assert _rel(out, ref) < 1e-5


def _dense_moe(x, params, k):
    """Every expert on every token, each token's top k kept (the dropless
    semantics, by brute force)."""
    probs, ids, _ = moe.route(x, params["router"], k)
    y = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for s in range(k):
            e = int(ids[t, s])
            gate, up = (params["w_in"][e] @ x[t]).chunk(2)
            y[t] += probs[t, s].to(x.dtype) * (
                params["w_out"][e] @ (torch.nn.functional.silu(gate) * up))
    return y


@pytest.mark.parametrize("static", [False, True], ids=["prefill", "decode"])
def test_dropless_where_the_capacity_path_drops(static):
    """A decode batch of 8 tokens, seven of them one token, whose 3
    experts then take 7 assignments each, past the capacity path's cap_e =
    round(8 k / E 2.0) = 6: it drops them (cf 2.0), the dropless paths give
    every token all of its k experts, the same bits run to run."""
    cfg = _cfg()
    g = torch.Generator().manual_seed(0)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff
    params = {"router": torch.randn((D, E), generator=g, dtype=torch.float64),
              "w_in": torch.randn((E, 2 * F, D), generator=g, dtype=torch.float64) * 0.1,
              "w_out": torch.randn((E, D, F), generator=g, dtype=torch.float64) * 0.1}
    x = torch.randn((8, D), generator=g, dtype=torch.float64)
    x[1:] = x[0]
    cap = round(8 * cfg.top_k / E * 2.0)
    _, ids, _ = moe.route(x, params["router"], cfg.top_k)
    loads = moe.expert_loads(ids, E)
    assert int(loads.max()) > cap
    y, ids2, got_loads = moe.moe_dropless(x, params, cfg.top_k, static=static)
    assert torch.equal(ids, ids2)
    assert (got_loads is None) == static or got_loads == loads.tolist()
    want = _dense_moe(x, params, cfg.top_k)
    assert _rel(y, want) < 1e-12
    capped, _, _ = granite_faults.capped_moe(x, params, cfg.top_k, static=static)
    assert _rel(capped, want) > 1e-3
    assert torch.equal(moe.moe_dropless(x, params, cfg.top_k, static=static)[0], y)


def test_a_decode_step_the_capacity_path_would_drop_from_matches_the_reference(case):
    """The smoke model serving four copies of one prompt: every decode
    step's MoE sends 4 tokens to each chosen expert, past cap_e = round(4 k
    / E 2.0) = 3; the dropless decode still gives the reference's logits."""
    cfg, conf, state, tok, _, _, model = case
    prompts = tok[:1, :40].expand(4, -1)
    seq = torch.cat([prompts, tok[:1, 40:43].expand(4, -1)], dim=1)
    ref = R.forward(_f64(state), conf, seq[:1], dtype=torch.float64)
    with torch.inference_mode():
        cache, _ = T.prefill(model, prompts, max_len=46)
        for s in range(40, 43):
            cache, lg = T.decode_step(model, cache, seq[:, s: s + 1])
            assert _rel(lg[0, 0, : cfg.vocab_size], ref[0, s]) < 1e-10
            loads = moe.expert_loads(cache["route"][0], cfg.n_experts)
            assert int(loads.max()) == 4 > round(4 * cfg.top_k / cfg.n_experts * 2.0)


def test_serve_keeps_the_moe_outputs_and_counts_the_routing(case):
    """``serve`` with rows to keep returns each MoE block's output on the
    prompt for them (the reference's taps); traced, each MoE block outside
    the decode graph is an ``lm.moe`` span and the counters sum the
    routing of every block."""
    cfg, conf, state, tok, _, _, model = case
    obs.reset()
    obs.enable()
    try:
        r = serve_lib.serve(cfg, tokens=4, device="cpu", model=model, prompts=tok[:, :37],
                            keep=[1])
    finally:
        obs.disable()
    snap = obs.snapshot()
    obs.reset()
    taps = {}
    R.forward(_f64(state), conf, tok[1:, :37], dtype=torch.float64, taps=taps)
    assert r.kept_taps["moe"].shape == (1, 4, 37, cfg.d_model)
    assert r.kept_taps["moe_decode"].shape == (1, 4, 3, cfg.d_model)
    for got, want in zip(r.kept_taps["moe"][0], taps["moe"]):
        assert _rel(got, want[0]) < 1e-10
    # the decode steps' MoE outputs: the reference over the prompt and the
    # greedy tokens the steps fed
    seq = torch.cat([tok[1:, :37], torch.from_numpy(r.generations[1:, :3])], dim=1)
    taps = {}
    R.forward(_f64(state), conf, seq, dtype=torch.float64, taps=taps)
    for got, want in zip(r.kept_taps["moe_decode"][0], taps["moe"]):
        assert _rel(got, want[0, 37:]) < 1e-10
    moes = [s for s in snap["spans"] if s[0] == "lm.moe"]
    assert len(moes) == 4 * 4 and {s[4][1] for s in moes} == {"prefill", "decode"}
    assert [s[4][2] for s in moes[:4]] == [2 * 37] * 4
    c = snap["counters"]
    assert c["lm.moe_blocks"] == 16
    assert c["lm.moe_assignments"] == 4 * (2 * 37 + 3 * 2) * cfg.top_k
    assert c["lm.moe_experts_hit"] <= 16 * cfg.n_experts and c["lm.moe_max_load"] > 0
    assert snap["device_ms"] == {}  # no CUDA events on the CPU


def test_observe_decode_reads_the_routing_buffer():
    cfg = _cfg()
    cache = granite4h.init_cache(cfg, 2, 8, device="cpu", dtype=torch.float32)
    cache["route"][:] = torch.tensor([[0, 1, 2], [0, 1, 3]])
    obs.reset()
    obs.enable()
    try:
        granite4h.observe_decode(T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                               device="cpu"), cache)
    finally:
        obs.disable()
    c = obs.snapshot()["counters"]
    obs.reset()
    assert (c["lm.moe_blocks"], c["lm.moe_assignments"], c["lm.moe_experts_hit"],
            c["lm.moe_max_load"]) == (4, 4 * 6, 4 * 4, 4 * 2)


def test_launcher_serves_the_new_arch_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch

    assert launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "20", "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "[serve] granite-4.0-h-small-smoke" in out


def test_muP_multipliers_and_nope_attention_move_the_logits(case):
    """The residual multiplier, the embedding multiplier and the logits'
    scaling each reach the logits (a config without them does not match
    the reference), as does the attention's scale."""
    cfg, _, state, tok, ref, _, model = case
    for field, value in (("residual_multiplier", 1.0), ("embedding_multiplier", 1.0),
                         ("logits_scaling", 1.0), ("attention_multiplier", 0.25)):
        other = T.params_from_hf(state, dataclasses.replace(cfg, **{field: value}),
                                 "cpu").double()
        with torch.inference_mode():
            got = T.forward(other, tok)[..., : cfg.vocab_size]
        assert _rel(got, ref) > 1e-4, field
    assert math.isclose(cfg.attention_multiplier, 1 / cfg.d_head)
    assert np.isfinite(ref.numpy()).all()
