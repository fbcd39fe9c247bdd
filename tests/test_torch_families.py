"""Port parity, part 14: the LM families beyond the dense one (MoE, SSM,
hybrid, audio, VLM): M-RoPE and cross-attention, every family's smoke
model, and the serving launcher.

The JAX package and the port run the same numpy-seeded inputs, and the
same weights (the JAX package's, carried across by
``transformer.params_from_jax``), on the CPU, where the port's attention
runs ``chunked_attention``, the flash kernel's plain version.  Layers must
match within f32 rounding; the smoke models' logits within 2e-5 of the
largest logit, and their caches as tightly, as ``test_torch_lm.py`` holds
the dense family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import layers as jL
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.launch import serve as serve_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

FAMILIES = ("olmoe-1b-7b", "kimi-k2-1t-a32b", "mamba2-370m", "zamba2-7b",
            "whisper-medium", "qwen2-vl-7b")


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("d", [16, 112, 128])
def test_mrope_sections_equal_jax(d):
    assert L._mrope_sections(d) == jL._mrope_sections(d)
    assert sum(L._mrope_sections(d)) == d // 2
    assert L._mrope_sections(128) == (16, 24, 24)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_equals_jax_on_three_position_streams(dtype):
    """Three distinct streams (t, h, w), each moving every section: the
    port's index must pick what the JAX one-hot contraction picks."""
    rng = np.random.default_rng(0)
    B, S, H, d = 2, 11, 3, 32
    x = rng.normal(size=(B, S, H, d)).astype(np.float32)
    pos = np.stack([rng.integers(0, 500, (B, S)), rng.integers(0, 40, (B, S)),
                    rng.integers(0, 60, (B, S))]).astype(np.int32)
    assert len({tuple(p.ravel()) for p in pos}) == 3
    secs = L._mrope_sections(d)
    for theta in (1e4, 1e6):
        if dtype == "float32":
            got = L.apply_mrope(_t(x), torch.from_numpy(pos), theta, secs)
            want = jL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, secs)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        else:
            xb = _t(x).to(torch.bfloat16)
            got = L.apply_mrope(xb, torch.from_numpy(pos), theta, secs)
            want = jL.apply_mrope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                                  theta, secs)
            assert got.dtype == torch.bfloat16
            # the same f32 rotation, one bf16 rounding: equal but for ties
            assert _rel_err(got.float().numpy(), np.asarray(want, np.float32)) < 1e-2
    # one stream alone equals plain RoPE on that stream
    same = np.broadcast_to(pos[0], (3, B, S))
    got = L.apply_mrope(_t(x), torch.from_numpy(np.ascontiguousarray(same)), 1e4, secs)
    plain = L.apply_rope(_t(x), torch.from_numpy(pos[0]), 1e4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_equals_jax(qk_norm):
    """cross_kv: no RoPE, qk_norm on q only, non-causal attention over the
    encoder's K, V (Skv 19 is not a multiple of kv_chunk 16)."""
    cfg = dataclasses.replace(configs.get_arch("whisper-medium", smoke=True),
                              qk_norm=qk_norm)
    jcfg = dataclasses.replace(jconfigs.get_arch("whisper-medium", smoke=True),
                               qk_norm=qk_norm)
    rng = np.random.default_rng(4)
    D, H, d = cfg.d_model, cfg.n_heads, cfg.d_head
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wq", (D, H * d)), ("wk", (D, H * d)), ("wv", (D, H * d)),
                      ("wo", (H * d, D)))}
    if qk_norm:
        p["q_norm"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
        p["k_norm"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
    x = rng.normal(size=(2, 7, D)).astype(np.float32)
    xk = rng.normal(size=(2, 19, H, d)).astype(np.float32)
    xv = rng.normal(size=(2, 19, H, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    got, cache = L.attention({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                             torch.from_numpy(np.ascontiguousarray(pos)),
                             causal=True, cross_kv=(_t(xk), _t(xv)))
    want, _ = jL.attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                           jcfg, jnp.asarray(pos), causal=True,
                           cross_kv=(jnp.asarray(xk), jnp.asarray(xv)))
    assert cache is None and got.shape == (2, 7, D)
    assert _rel_err(got.numpy(), want) < 2e-6


# -------------------------------------------------------------- the models
def _jax_model(arch_id, seed=0):
    """JAX smoke params and the port's model of the same weights; zamba2's
    LoRA b_q (zeros at init) filled with random values so the LoRA path
    is tested."""
    cfg = jconfigs.get_arch(arch_id, smoke=True)
    params = jT.init_params(jax.random.key(seed), cfg)
    if cfg.family == "hybrid":
        b_q = params["shared_attn"]["lora"]["b_q"]
        rnd = np.random.default_rng(seed + 50).normal(size=b_q.shape) * 0.5
        params["shared_attn"]["lora"]["b_q"] = jnp.asarray(rnd, b_q.dtype)
    model = T.params_from_jax(jax.tree.map(np.asarray, params),
                              configs.get_arch(arch_id, smoke=True), "cpu")
    return cfg, params, model


def _frames(cfg, B, seed=9):
    """Seeded random frame embeddings for the audio family, else None."""
    if cfg.family != "audio":
        return None
    return np.random.default_rng(seed).normal(
        size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _opt(a, fn):
    return None if a is None else fn(a)


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_smoke_model_matches_jax(arch_id):
    """forward, prefill of a 13-token prompt (not a multiple of kv_chunk
    16 or ssm_chunk 16) and three decode steps: logits within 2e-5 of
    JAX's, relative to the largest, and the same caches."""
    jcfg, params, model = _jax_model(arch_id)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    fr = _frames(jcfg, 2)
    with torch.inference_mode():
        got = T.forward(model, tt, frames=_opt(fr, _t))
    want = jT.forward(params, jnp.asarray(toks), jcfg, frames=_opt(fr, jnp.asarray))
    assert got.shape == (2, 16, jcfg.vocab_padded)
    assert _rel_err(got.numpy(), want) < 2e-5

    S, max_len = 13, 20
    jcache, jlg = jT.prefill(params, jnp.asarray(toks[:, :S]), jcfg, max_len=max_len,
                             frames=_opt(fr, jnp.asarray))
    with torch.inference_mode():
        cache, lg = T.prefill(model, tt[:, :S], max_len=max_len, frames=_opt(fr, _t))
    assert _rel_err(lg.numpy(), jlg) < 2e-5
    for t in range(S, S + 3):
        jcache, jlg = jT.decode_step(params, jcache, jnp.asarray(toks[:, t : t + 1]), jcfg)
        with torch.inference_mode():
            cache, lg = T.decode_step(model, cache, tt[:, t : t + 1])
        assert lg.shape == (2, 1, jcfg.vocab_padded)
        assert _rel_err(lg.numpy(), jlg) < 2e-5
    assert cache["len"] == int(jcache["len"]) == S + 3
    assert set(cache) == set(jcache)
    for name in set(cache) - {"len"}:
        assert cache[name].shape == jcache[name].shape, name
        assert _rel_err(cache[name].numpy(), jcache[name]) < 2e-5, name


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_params_round_trip_through_numpy(arch_id):
    _, params, model = _jax_model(arch_id, seed=2)
    back = T.params_to_numpy(model)
    flat, tree = jax.tree.flatten(jax.tree.map(np.asarray, params))
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree == tree_b
    for a, b in zip(flat, flat_b):
        assert b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_bf16_weights_keep_the_jax_dtypes(arch_id):
    """A bf16 model keeps the router and the SSM gains in f32, as the JAX
    package does; every other leaf is bf16, on init and across the
    carry."""
    kw = dict(dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_arch(arch_id, smoke=True), **kw)
    jcfg = dataclasses.replace(jconfigs.get_arch(arch_id, smoke=True), **kw)
    jparams = jT.init_params(jax.random.key(0), jcfg)
    want = {jax.tree_util.keystr(p): str(np.asarray(x).dtype)
            for p, x in jax.tree_util.tree_leaves_with_path(jparams)}
    for model in (T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                device="cpu"),
                  T.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")):
        got = {jax.tree_util.keystr(p): str(x.dtype).replace("torch.", "")
               for p, x in jax.tree_util.tree_leaves_with_path(_torch_tree(model))}
        assert got == want


def _torch_tree(model):
    """The model's weights as the JAX tree, each leaf a torch tensor, the
    stacked trees as lists of layers."""
    out = {"embed": model.embed, "lm_head": model.lm_head,
           "final_norm": model.final_norm.gamma,
           "blocks": model.blocks[0].tree()}
    if model.shared_attn is not None:
        out["shared_attn"] = model.shared_attn.tree()
    if model.cfg.family == "audio":
        out.update(enc_blocks=model.enc_blocks[0].tree(), enc_norm=model.enc_norm.gamma,
                   cross_blocks=model.cross_blocks[0].tree())
    return out


@pytest.mark.parametrize("arch_id", ["zamba2-7b", "mamba2-370m", "olmoe-1b-7b",
                                     "whisper-medium", "qwen2-vl-7b", "kimi-k2-1t-a32b"])
def test_serve_matches_forward(arch_id):
    """prefill + decode logits equal the training forward, per token (the
    JAX package's property and tolerance, on the port's own random
    weights; the smoke MoE configs' capacity factor 4 drops nothing at
    decode)."""
    cfg = configs.get_arch(arch_id, smoke=True)
    g = torch.Generator().manual_seed(1)
    model = T.init_params(cfg, generator=g, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    frames = (torch.randn((2, cfg.enc_seq, cfg.d_model), generator=g)
              if cfg.family == "audio" else None)
    with torch.inference_mode():
        full = T.forward(model, toks, frames=frames)
        cache, lg = T.prefill(model, toks[:, :6], max_len=14, frames=frames)
        outs = [lg]
        for t in range(6, 12):
            cache, lg = T.decode_step(model, cache, toks[:, t : t + 1])
            outs.append(lg)
    served = torch.cat(outs, dim=1)
    assert _rel_err(served.numpy(), full.numpy()) < 3e-3


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_float64_model_is_the_f32_model_in_float64(arch_id):
    """A model cast to float64 (the CPU reference of the card's f32 check)
    computes every family's layers and caches in float64 (the SSM state
    too) and agrees with the f32 model within f32 rounding."""
    import copy

    cfg = configs.get_arch(arch_id, smoke=True)
    m32 = T.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    m64 = copy.deepcopy(m32).double()
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=g)
    fr = (torch.randn((2, cfg.enc_seq, cfg.d_model), generator=g)
          if cfg.family == "audio" else None)
    with torch.inference_mode():
        c32, l32 = T.prefill(m32, toks[:, :7], max_len=10, frames=fr)
        c64, l64 = T.prefill(m64, toks[:, :7], max_len=10, frames=_opt(fr, torch.Tensor.double))
        assert l64.dtype == torch.float64
        assert all(v.dtype == torch.float64 for k, v in c64.items() if k != "len")
        assert _rel_err(l32, l64) < 2e-6
        for t in (7, 8):
            c32, l32 = T.decode_step(m32, c32, toks[:, t : t + 1])
            c64, l64 = T.decode_step(m64, c64, toks[:, t : t + 1])
            assert _rel_err(l32, l64) < 2e-6


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_init_is_seeded_on_every_family(arch_id):
    cfg = configs.get_arch(arch_id, smoke=True)
    a = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    b = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    c = T.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.lm_head, c.lm_head)
    assert len(a.blocks) == cfg.n_layers


# ------------------------------------------------------------ the launcher
@pytest.mark.parametrize("arch_id", FAMILIES)
def test_serve_launcher_runs_on_the_cpu(arch_id, capsys):
    before = build.FLASH_ATTENTION.launches
    rc = serve_lib.main(["--arch", arch_id, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "9", "--tokens", "4"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0 and build.FLASH_ATTENTION.launches == before
    assert out[0].startswith(f"[serve] {arch_id}-smoke: prefill[2x9]")
    assert "4 tokens in" in out[0] and out[1].startswith("[serve] sample generations:")
    cfg = configs.get_arch(arch_id, smoke=True)
    r = serve_lib.serve(cfg, batch=2, prompt_len=9, tokens=4, device="cpu")
    assert r.generations.shape == (2, 4) and r.device == "cpu"
    assert r.prefill_logits.shape == (2, 9, cfg.vocab_padded)
    assert bool(torch.isfinite(r.last_logits).all())
    assert int(r.generations.max()) < cfg.vocab_size


def test_audio_serving_takes_frames_in_the_model_dtype():
    """The default frames are zeros in the model's dtype (the JAX
    launcher's); seeded frames passed by the caller change the output."""
    cfg = configs.get_arch("whisper-medium", smoke=True)
    kw = dict(batch=2, prompt_len=5, tokens=3, device="cpu")
    r0 = serve_lib.serve(cfg, **kw)
    z = torch.zeros((2, cfg.enc_seq, cfg.d_model))
    rz = serve_lib.serve(cfg, frames=z, **kw)
    assert torch.equal(r0.prefill_logits, rz.prefill_logits)
    fr = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=torch.Generator().manual_seed(5))
    r1 = serve_lib.serve(cfg, frames=fr, **kw)
    assert not torch.equal(r0.prefill_logits, r1.prefill_logits)
    with pytest.raises(ValueError, match="frames"):
        T.forward(T.init_params(cfg, generator=torch.Generator(), device="cpu"),
                  torch.zeros((1, 3), dtype=torch.long))
