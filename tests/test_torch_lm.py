"""Port parity, part 8: the dense LM slice (configs, layers, transformer,
serving launcher).

The JAX package and the port run the same numpy-seeded inputs, and the
same weights (the JAX package's, carried across by
``transformer.params_from_jax``), on the CPU, where the port's attention
runs ``chunked_attention``, the flash kernel's plain version.  Layers must
match within f32 rounding; the smoke models' logits within 2e-5 of the
largest logit, and their KV caches as tightly.
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

DENSE = ("granite-3-8b", "qwen3-14b", "starcoder2-15b", "deepseek-coder-33b")


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch_id", DENSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_dense_configs_equal_jax(arch_id, smoke):
    cfg = configs.get_arch(arch_id, smoke=smoke)
    jcfg = jconfigs.get_arch(arch_id, smoke=smoke)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.vocab_padded == jcfg.vocab_padded
    assert cfg.d_head == jcfg.d_head


def test_registry_ports_the_dense_family_only():
    assert set(configs.ARCH_IDS) == set(DENSE)
    assert set(configs.ARCH_IDS) | set(configs.NOT_PORTED) == set(jconfigs.ARCH_IDS)
    for arch_id in configs.NOT_PORTED:
        with pytest.raises(KeyError, match="not ported yet"):
            configs.get_arch(arch_id)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("gpt-7")
    g = configs.get_arch("granite-3-8b")
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv_heads, g.d_head,
            g.d_ff, g.vocab_size, g.vocab_padded) == (
        40, 4096, 32, 8, 128, 12800, 49155, 49408)
    assert 8.3e9 < g.param_count() < 8.5e9


# ------------------------------------------------------------------- layers
def test_rmsnorm_and_rope_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    got = L.rmsnorm(_t(x), _t(gamma))
    want = jL.rmsnorm(jnp.asarray(x), jnp.asarray(gamma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    pos = np.stack([np.arange(9), np.arange(5, 14)]).astype(np.int32)
    for theta in (1e4, 1e6):
        got = L.apply_rope(_t(x), torch.from_numpy(pos), theta)
        want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # bf16 in, bf16 out, rotated in f32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = L.apply_rope(xb, torch.from_numpy(pos), 1e4)
    want = jL.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), 1e4)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().numpy(), np.asarray(want, np.float32)) < 1e-2


def test_mlp_equals_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    got = L.mlp({k: _t(v) for k, v in p.items()}, _t(x))
    want = jL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    assert _rel_err(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,hkv,g,kv_chunk,q_offset", [
    (16, 16, 2, 2, 16, 0),    # one chunk
    (13, 13, 2, 2, 16, 0),    # Skv not a multiple of kv_chunk
    (20, 45, 1, 4, 16, 25),   # chunked prefill: q at positions 25..44
    (1, 37, 2, 3, 8, 36),     # one decode row over a ragged cache
    (24, 24, 3, 1, 7, 0),     # MHA, chunk 7
])
def test_chunked_attention_equals_jax(causal, sq, skv, hkv, g, kv_chunk, q_offset):
    rng = np.random.default_rng(sq * 100 + skv + g)
    q = rng.normal(size=(2, sq, hkv, g, 16)).astype(np.float32)
    k = rng.normal(size=(2, skv, hkv, 16)).astype(np.float32)
    v = rng.normal(size=(2, skv, hkv, 16)).astype(np.float32)
    got = L.chunked_attention(_t(q), _t(k), _t(v), causal, q_offset=q_offset,
                              kv_chunk=kv_chunk)
    want = jL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal, q_offset=q_offset, kv_chunk=kv_chunk)
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) < 2e-6


def test_chunked_attention_bf16_equals_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 21, 2, 2, 32)).astype(np.float32)
    k = rng.normal(size=(1, 21, 2, 32)).astype(np.float32)
    v = rng.normal(size=(1, 21, 2, 32)).astype(np.float32)
    for bf16_scores in (False, True):
        got = L.chunked_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                                  True, kv_chunk=8, bf16_scores=bf16_scores)
        want = jL.chunked_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                    True, kv_chunk=8, bf16_scores=bf16_scores)
        assert _rel_err(got.float().numpy(), np.asarray(want, np.float32)) < 2e-2


# -------------------------------------------------------------- the slice
def _jax_model(arch_id, seed=0):
    cfg = jconfigs.get_arch(arch_id, smoke=True)
    params = jT.init_params(jax.random.key(seed), cfg)
    model = T.params_from_jax(jax.tree.map(np.asarray, params),
                              configs.get_arch(arch_id, smoke=True), "cpu")
    return cfg, params, model


@pytest.mark.parametrize("arch_id", ["granite-3-8b", "qwen3-14b"])
def test_smoke_model_matches_jax(arch_id):
    """forward, prefill of a 13-token prompt (not a multiple of kv_chunk
    16) and three decode steps: logits within 2e-5 of JAX's, relative to
    the largest, and the same KV caches."""
    jcfg, params, model = _jax_model(arch_id)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        got = T.forward(model, tt)
    want = jT.forward(params, jnp.asarray(toks), jcfg)
    assert got.shape == (2, 16, jcfg.vocab_padded)
    assert _rel_err(got.numpy(), want) < 2e-5

    S, max_len = 13, 20
    jcache, jlg = jT.prefill(params, jnp.asarray(toks[:, :S]), jcfg, max_len=max_len)
    with torch.inference_mode():
        cache, lg = T.prefill(model, tt[:, :S], max_len=max_len)
    assert _rel_err(lg.numpy(), jlg) < 2e-5
    for t in range(S, S + 3):
        jcache, jlg = jT.decode_step(params, jcache, jnp.asarray(toks[:, t : t + 1]), jcfg)
        with torch.inference_mode():
            cache, lg = T.decode_step(model, cache, tt[:, t : t + 1])
        assert lg.shape == (2, 1, jcfg.vocab_padded)
        assert _rel_err(lg.numpy(), jlg) < 2e-5
    assert cache["len"] == int(jcache["len"]) == S + 3
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=1e-5, atol=1e-5)


def test_params_round_trip_through_numpy():
    _, params, model = _jax_model("qwen3-14b", seed=2)
    back = T.params_to_numpy(model)
    flat, tree = jax.tree.flatten(jax.tree.map(np.asarray, params))
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree == tree_b
    for a, b in zip(flat, flat_b):
        assert b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("arch_id", ["granite-3-8b", "starcoder2-15b"])
def test_serve_matches_forward(arch_id):
    """prefill + decode logits equal the training forward, per token (the
    JAX package's property, on the port's own random weights)."""
    cfg = configs.get_arch(arch_id, smoke=True)
    g = torch.Generator().manual_seed(1)
    model = T.init_params(cfg, generator=g, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    with torch.inference_mode():
        full = T.forward(model, toks)
        cache, lg = T.prefill(model, toks[:, :6], max_len=14)
        outs = [lg]
        for t in range(6, 12):
            cache, lg = T.decode_step(model, cache, toks[:, t : t + 1])
            outs.append(lg)
    served = torch.cat(outs, dim=1)
    assert _rel_err(served.numpy(), full.numpy()) < 3e-3


def _serve_vs_forward_jax(params, toks, cfg):
    full = jT.forward(params, toks, cfg)
    cache, lg = jT.prefill(params, toks[:, :6], cfg, max_len=14)
    outs = [lg]
    for t in range(6, 12):
        cache, lg = jT.decode_step(params, cache, toks[:, t : t + 1], cfg)
        outs.append(lg)
    return _rel_err(jnp.concatenate(outs, axis=1), full), full


def test_bf16_serve_matches_forward_as_closely_as_the_reference():
    """In bf16 the logits are rounded to bf16: one step at the largest
    logit (~5 for the full vocabulary) is ~6e-3 of it, so the property's
    f32 tolerance (3e-3) is below what the JAX package itself reaches.
    Both packages stay within two steps, on the same weights."""
    kw = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_head=64,
              d_ff=512, vocab_size=49155, dtype="bfloat16", kv_chunk=1024)
    jcfg = dataclasses.replace(jconfigs.get_arch("granite-3-8b", smoke=True), **kw)
    cfg = dataclasses.replace(configs.get_arch("granite-3-8b", smoke=True), **kw)
    params = jT.init_params(jax.random.key(1), jcfg)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    e_jax, full = _serve_vs_forward_jax(params, jnp.asarray(toks), jcfg)
    mx = float(np.abs(np.asarray(full, np.float32)).max())
    step = 2.0 ** (np.floor(np.log2(mx)) - 7) / mx
    assert 3e-3 < step < e_jax <= 2 * step

    model = T.params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), params),
                              cfg, "cpu")
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        f = T.forward(model, tt)
        cache, lg = T.prefill(model, tt[:, :6], max_len=14)
        outs = [lg]
        for t in range(6, 12):
            cache, lg = T.decode_step(model, cache, tt[:, t : t + 1])
            outs.append(lg)
    e_port = _rel_err(torch.cat(outs, dim=1).float().numpy(), f.float().numpy())
    assert e_port <= 2 * step


def test_init_params_is_seeded_and_dense_only():
    cfg = configs.get_arch("granite-3-8b", smoke=True)
    a = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    b = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert len(a.blocks) == cfg.n_layers
    n = sum(p.numel() for p in a.parameters())
    # param_count counts the unpadded vocabulary and no norms
    pad = 2 * (cfg.vocab_padded - cfg.vocab_size) * cfg.d_model
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    assert n == cfg.param_count() + pad + norms
    moe = dataclasses.replace(cfg, family="moe")
    with pytest.raises(NotImplementedError, match="queue 1"):
        T.init_params(moe, generator=torch.Generator(), device="cpu")


# ------------------------------------------------------------ the launcher
def test_serve_launcher_runs_on_the_cpu(capsys):
    before = build.FLASH_ATTENTION.launches
    rc = serve_lib.main(["--arch", "granite-3-8b", "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "9", "--tokens", "4"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0 and build.FLASH_ATTENTION.launches == before
    assert out[0].startswith("[serve] granite-3-8b-smoke: prefill[2x9]")
    assert "4 tokens in" in out[0] and out[1].startswith("[serve] sample generations:")
    r = serve_lib.serve(configs.get_arch("granite-3-8b", smoke=True), batch=2,
                        prompt_len=9, tokens=4, device="cpu")
    assert r.generations.shape == (2, 4) and r.device == "cpu"
    assert r.prefill_logits.shape == (2, 9, 256)
    assert bool(torch.isfinite(r.last_logits).all())


def test_serve_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_lib.main(["--arch", "granite-3-8b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lib.serve(configs.get_arch("granite-3-8b", smoke=True), batch=1,
                        prompt_len=4, tokens=2)
