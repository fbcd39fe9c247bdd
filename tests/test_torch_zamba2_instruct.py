"""Zamba2 as published (``zamba2-7b-instruct``, a port-only id): the port
against its plain reference (``nspubench/reference/zamba2.py``) at a small
instruct-shaped size on the CPU in float64, and the reference against
``transformers``' ``Zamba2ForCausalLM`` on the same state dict.

The smoke config has 7 layers with hybrid ids 2 and 5 (two mem blocks, one
application each), 2 SSM groups, chunk 16, adapter rank 4 and head dim
2 d_model / n_heads; prompts are 3 chunks and more.  Weights are drawn by
the published init rule and then made non-trivial (norms, conv biases and
D away from 1 and 0, projections 10x the init's 0.02), so every term of
the layer equations moves the logits.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from nspubench.reference import zamba2 as R
from repro_torch import configs, obs
from repro_torch.kernels import flash_attention as flash_lib
from repro_torch.launch import serve as serve_lib
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models import zamba2

ARCH = "zamba2-7b-instruct"


def _cfg():
    return configs.get_arch(ARCH, smoke=True)


def _state(cfg, seed=7):
    conf = zamba2.hf_config(cfg)
    state = R.init_state(conf, seed, "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in state.items():
        if "norm" in k or k.endswith(("conv1d.bias", ".D")):
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
    tok = torch.randint(0, cfg.vocab_size, (2, 56), generator=torch.Generator().manual_seed(3))
    ref = R.forward(_f64(state), conf, tok, dtype=torch.float64)
    model = T.params_from_hf(state, cfg, "cpu").double()
    return cfg, conf, state, tok, ref, model


def test_config_is_the_published_one_and_a_port_only_id():
    cfg = configs.get_arch(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim) == (
        81, 3584, 7168, 112, 64)
    assert (cfg.ssm_state, cfg.ssm_groups, cfg.ssm_chunk, cfg.conv_bias) == (64, 2, 256, True)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff) == (32, 32, 224, 14336)
    assert cfg.hybrid_layer_ids == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)
    assert (cfg.num_mem_blocks, cfg.adapter_rank, cfg.mlp_act) == (2, 128, "gelu")
    assert (cfg.vocab_size, cfg.rope_theta, cfg.norm_eps, cfg.tie_embeddings) == (
        32000, 1e4, 1e-5, True)
    assert 7.3e9 < cfg.param_count() < 7.4e9
    assert ARCH not in configs.ARCH_IDS and len(configs.ARCH_IDS) == 10
    # the JAX package's variant keeps every field and its class defaults
    old = configs.get_arch("zamba2-7b")
    assert type(old).__name__ == "ArchConfig" and "ssm_groups" not in dataclasses.asdict(old)
    assert (old.ssm_groups, old.conv_bias, old.norm_eps, old.ssm_norm, old.family) == (
        1, False, 1e-6, "rmsnorm", "hybrid")
    assert (cfg.family, cfg.ssm_norm) == ("zamba2", "grouped")
    # the published config's keys give the same config back
    assert zamba2.config_from_hf(zamba2.hf_config(cfg), ARCH) == dataclasses.replace(
        cfg, vocab_pad_to=256)


def test_prefill_logits_match_the_reference(case):
    cfg, _, _, tok, ref, model = case
    with torch.inference_mode():
        full = T.forward(model, tok)[..., : cfg.vocab_size]
        _, pre = T.prefill(model, tok, max_len=64)
    assert _rel(full, ref) < 1e-6
    assert _rel(pre[..., : cfg.vocab_size], ref) < 1e-6


def test_prefill_then_decode_through_both_caches_matches_the_full_forward(case):
    """A 40-token prefill (3 chunks of 16, the last ragged), then 16 decode
    steps through the conv, SSM and per-application KV caches, against
    the reference's full forward over all 56 tokens."""
    cfg, _, _, tok, ref, model = case
    with torch.inference_mode():
        cache, lp = T.prefill(model, tok[:, :40], max_len=64)
        assert cache["k"].shape == (2, 2, 64, cfg.n_heads, cfg.d_head)
        steps = []
        for t in range(40, 56):
            cache, lg = T.decode_step(model, cache, tok[:, t: t + 1])
            steps.append(lg)
    assert cache["len"] == 56
    assert _rel(lp[..., : cfg.vocab_size], ref[:, :40]) < 1e-6
    assert _rel(torch.cat(steps, 1)[..., : cfg.vocab_size], ref[:, 40:]) < 1e-6


def test_decode_with_its_position_on_the_device_leaves_len_unread(case):
    """``decode_step`` on a cache holding a device position (what the
    card's CUDA graph captures: the position an int64 tensor, K and V
    written by ``index_copy_``, the attention's length a device int) reads
    that position, never the cache's 'len': with 'len' left at 0 it gives
    the logits and caches of the steps at 'len', step after step."""
    cfg, _, _, tok, _, model = case
    with torch.inference_mode():
        c1, _ = T.prefill(model, tok[:, :40], max_len=64)
        c2 = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in c1.items()}
        c2["len"] = 0
        for t in range(40, 46):
            c1, want = T.decode_step(model, c1, tok[:, t: t + 1])
            at = dict(c2, pos=torch.tensor([t], dtype=torch.long))
            got = T.decode_step(model, at, tok[:, t: t + 1])[1]
            assert torch.equal(got, want), t
    for k in ("conv", "S", "k", "v"):
        assert torch.equal(c1[k], c2[k]), k
    assert c2["len"] == 0 and c1["len"] == 46


def test_chunked_cached_prefill_equals_the_one_chunk_form():
    """The cached block at chunk 16 over 50 tokens (4 chunks, the state
    carried) against the same block as one chunk: outputs and states
    agree to float64 rounding; the chunk counter counts the chunks."""
    cfg = _cfg()
    gen = torch.Generator().manual_seed(11)
    p = {k: (v + 0.2 * torch.randn(v.shape, generator=gen)).double()
         for k, v in ssm.init_ssm_block(gen, cfg).items()}
    h = torch.randn((2, 50, cfg.d_model), generator=gen, dtype=torch.float64)
    G, N = cfg.ssm_groups, cfg.ssm_state

    def zero():
        return {"conv": torch.zeros((2, ssm.CONV_K - 1, cfg.d_inner + 2 * G * N),
                                    dtype=torch.float64),
                "S": torch.zeros((2, cfg.ssm_heads, N, cfg.ssm_head_dim), dtype=torch.float64)}

    obs.reset()
    obs.enable()
    try:
        y, c = ssm.ssm_block_apply(p, h, cfg, cache=zero())
    finally:
        obs.disable()
    assert obs.snapshot()["counters"]["lm.ssm_chunks"] == 4
    one = dataclasses.replace(cfg, ssm_chunk=64)
    y1, c1 = ssm.ssm_block_apply(p, h, one, cache=zero())
    assert _rel(y, y1) < 1e-12 and _rel(c["S"], c1["S"]) < 1e-12
    assert torch.equal(c["conv"], c1["conv"])
    # and the no-cache scan at chunk 16
    y2, _ = ssm.ssm_block_apply(p, h, cfg)
    assert _rel(y2, y1) < 1e-12


@pytest.mark.parametrize("arch_id", [ARCH, "mamba2-370m", "zamba2-7b"])
def test_one_token_step_equals_the_chunked_scan(arch_id):
    """A decode step's token through the block (``ssm._one_token``: the
    conv over its window, one step of the recurrence, in place of a chunk
    of one token) after a 20-token cached prefill, against the same 21
    tokens through the chunked scan: the last output and the states agree
    to float64 rounding, for the published Zamba2's block (2 groups, conv
    bias, the grouped norm) and the JAX package's (1 group, its norm)."""
    cfg = configs.get_arch(arch_id, smoke=True)
    gen = torch.Generator().manual_seed(12)
    p = {k: (v + 0.2 * torch.randn(v.shape, generator=gen)).double()
         for k, v in ssm.init_ssm_block(gen, cfg).items()}
    h = torch.randn((2, 21, cfg.d_model), generator=gen, dtype=torch.float64)
    G, N = cfg.ssm_groups, cfg.ssm_state
    zero = {"conv": torch.zeros((2, ssm.CONV_K - 1, cfg.d_inner + 2 * G * N),
                                dtype=torch.float64),
            "S": torch.zeros((2, cfg.ssm_heads, N, cfg.ssm_head_dim), dtype=torch.float64)}
    want, cw = ssm.ssm_block_apply(p, h, cfg, cache=dict(zero))
    _, c = ssm.ssm_block_apply(p, h[:, :20], cfg, cache=dict(zero))
    got, c = ssm.ssm_block_apply(p, h[:, 20:], cfg, cache=c)
    assert got.shape == (2, 1, cfg.d_model)
    assert _rel(got, want[:, 20:]) < 1e-12 and _rel(c["S"], cw["S"]) < 1e-12
    assert torch.equal(c["conv"], cw["conv"])


def test_each_hybrid_layer_runs_its_block_and_its_adapter(case):
    cfg, conf, state, tok, ref, model = case
    obs.reset()
    obs.enable()
    try:
        with torch.inference_mode():
            T.forward(model, tok)
    finally:
        obs.disable()
    spans = [s[4] for s in obs.snapshot()["spans"] if s[0] == "lm.shared_block"]
    assert spans == [(2, 0, 0), (5, 1, 1)]  # (hybrid layer id, block, application)
    # the published block map at full depth: application a uses block a % 2
    full = configs.get_arch(ARCH)
    assert [a % full.num_mem_blocks for a in range(full.n_apps)] == [0, 1] * 6 + [0]
    # the applications' adapters swapped: no longer the reference
    swapped = T.params_from_hf(state, cfg, "cpu").double()
    a0, a1 = swapped.apps[0], swapped.apps[1]
    with torch.no_grad():
        for name in ("adapter_a", "adapter_b"):
            x, y = getattr(a0, name).clone(), getattr(a1, name).clone()
            getattr(a0, name).copy_(y)
            getattr(a1, name).copy_(x)
        got = T.forward(swapped, tok)[..., : cfg.vocab_size]
    assert _rel(got, ref) > 1e-3


def test_the_blocks_output_reaches_the_mamba_input_not_the_residual(case):
    """With the mamba layers at the hybrid ids silenced (out_proj 0), the
    logits do not move whatever the applications' linears are: the shared
    block's output enters only the input of the next mamba layer.  With
    those layers live, the same change moves them."""
    cfg, conf, state, tok, _, _ = case
    quiet = dict(state)
    for lid in cfg.hybrid_layer_ids:
        k = f"model.layers.{lid}.mamba_decoder.mamba.out_proj.weight"
        quiet[k] = torch.zeros_like(state[k])

    def logits(st, scale):
        st = dict(st)
        for lid in cfg.hybrid_layer_ids:
            k = f"model.layers.{lid}.linear.weight"
            st[k] = st[k] * scale
        m = T.params_from_hf(st, cfg, "cpu").double()
        with torch.inference_mode():
            return T.forward(m, tok)[..., : cfg.vocab_size]

    assert torch.equal(logits(quiet, 1.0), logits(quiet, 5.0))
    assert _rel(logits(state, 5.0), logits(state, 1.0)) > 1e-3


def test_reference_matches_transformers_zamba2_on_the_same_state_dict():
    """The reference against ``Zamba2ForCausalLM`` (eager attention,
    ``torch_forward``'s SSD) in float64 on one state dict.  The sequence
    is one of its SSD chunks: across chunks ``torch_forward`` sums its
    chunk-state pass over the target chunk (``.sum(dim=2)``) where the
    recurrence sums over the source, so its output changes with
    ``chunk_size`` (0.18 between chunk 16 and 64 over 50 tokens on these
    weights); within a chunk it is the recurrence.  The bound is the f32
    rounding ``torch_forward`` keeps in float64 mode (A, x, B and C cast to
    f32 and the RoPE angles in f32)."""
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    cfg = _cfg()
    conf, state = _state(cfg, seed=21)
    tok = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(5))
    ref = R.forward(_f64(state), conf, tok, dtype=torch.float64)
    hc = transformers.Zamba2Config(**{k: v for k, v in conf.items() if k != "hybrid_layer_ids"})
    hc.chunk_size = 64
    hc._attn_implementation = "eager"
    assert hc.hybrid_layer_ids == list(cfg.hybrid_layer_ids)
    hf = transformers.Zamba2ForCausalLM(hc).double().eval()
    missing = hf.load_state_dict(_f64(state), strict=False)
    # tied head; each shared block is read where the state dict holds it
    assert missing.missing_keys == [k for k in missing.missing_keys
                                    if k == "lm_head.weight" or "shared_transformer" in k]
    assert not missing.unexpected_keys
    with torch.no_grad():
        got = hf(tok, use_cache=False).logits
    assert _rel(got, ref) < 2e-5


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_version_at_head_dim_224(causal):
    """Head dim 224 on the CPU (the kernel's plain version), Zamba2's scale
    (224 / 2)^-1/2, against softmax attention written out; and K, V as the
    leading rows of a longer cache."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 70, 4, 224), generator=g, dtype=torch.float64)
               for _ in range(3))
    scale = 112 ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = s.masked_fill(torch.ones(70, 70, dtype=torch.bool).triu(1), -np.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    got = flash_lib.flash_attention(q, k, v, causal, scale=scale)
    # the scale is rounded to f32, as the kernel's float argument is
    assert 224 in flash_lib.HEAD_DIMS and _rel(got, want) < 1e-7
    cache = torch.cat([k, torch.full_like(k, 1e4)], dim=1)
    got = flash_lib.flash_attention(q[:, -1:], cache[:, :70], v, False, scale=scale)
    assert _rel(got, flash_lib.flash_attention(q[:, -1:], k, v, False, scale=scale)) == 0
    assert flash_lib._kv_rows(cache[:, :70]) == 140 and flash_lib._kv_rows(k) == 70


def test_serve_takes_the_callers_prompts_and_keeps_step_logits(case):
    cfg, _, state, tok, ref, _ = case
    model = T.params_from_hf(state, cfg, "cpu").double()
    obs.reset()
    obs.enable()
    try:
        r = serve_lib.serve(cfg, tokens=5, device="cpu", model=model, prompts=tok[:, :40],
                            keep=[1])
    finally:
        obs.disable()
    snap = obs.snapshot()
    assert r.generations.shape == (2, 5) and r.step_logits.shape == (1, 4, cfg.vocab_padded)
    assert _rel(r.prefill_logits[..., : cfg.vocab_size], ref[:, :40]) < 1e-6
    # teacher forcing on the served tokens: the reference's full forward
    seq = torch.cat([tok[:, :40], torch.from_numpy(r.generations[:, :4])], dim=1)
    want = R.forward(_f64(state), zamba2.hf_config(cfg), seq, dtype=torch.float64)
    assert _rel(r.step_logits[0, :, : cfg.vocab_size], want[1, 40:44]) < 1e-6
    # the kept row's final cache: each application's K and V over the 44
    # positions the steps consumed, each layer's SSM state after them
    taps = {}
    R.forward(_f64(state), zamba2.hf_config(cfg), seq[1:], dtype=torch.float64, taps=taps)
    kc = r.kept_cache
    assert kc["k"].shape == (2, 1, 46, cfg.n_heads, cfg.d_head)
    for a in range(2):
        assert _rel(kc["k"][a, 0, :44], taps["k"][a][0]) < 1e-6
        assert _rel(kc["v"][a, 0, :44], taps["v"][a][0]) < 1e-6
    for i in range(cfg.n_layers):
        assert _rel(kc["S"][i, 0], taps["S"][i][0]) < 1e-6
    names = [s[0] for s in snap["spans"]]
    assert names.count("lm.prefill") == 1 and names.count("lm.decode_step") == 4
    assert names.count("lm.shared_block") == 2 * 5
    c = snap["counters"]
    assert (c["lm.tokens_prefilled"], c["lm.tokens_decoded"]) == (80, 8)
    # K and V of 2 applications: the prompt's 40 rows, then one a step
    assert c["lm.kv_bytes"] == 2 * 2 * 2 * (40 + 4) * cfg.n_heads * cfg.d_head * 8


def test_launcher_serves_the_new_arch_on_the_cpu(capsys):
    assert serve_lib.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--prompt-len", "40", "--tokens", "3", "--batch", "2"]) == 0
    assert "zamba2-7b-instruct-smoke" in capsys.readouterr().out
