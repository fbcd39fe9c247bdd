"""Port parity, part 16: the Mamba2 block (``models/ssm.py``).

The JAX package and the port run the same numpy-seeded inputs and weights
on the CPU: the causal conv with and without its state, the chunked SSD
scan at chunks 1, 8, 29 and 64 (the JAX package's own test shapes), its
sequential oracle, and the whole block with and without the decode cache,
all within 1e-5 of the largest output, in f32 and in bf16 (the dual
form's operands rounded to bf16, as the JAX package rounds them): the
port's bf16 scan is held to JAX's bf16 scan, not to f32, and sits far
closer to it than JAX's bf16 scan sits to its own f32 scan.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.models import ssm


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _ssd_inputs(seed=0, B=2, L=29, H=3, dh=8, N=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, H, dh)).astype(np.float32),
            rng.uniform(0.01, 0.2, (B, L, H)).astype(np.float32),
            (-rng.uniform(0.5, 2, (H,))).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32),
            rng.normal(size=(B, H, N, dh)).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("L", [1, 9])
def test_causal_conv_equals_jax(with_state, L):
    rng = np.random.default_rng(L)
    u = rng.normal(size=(2, L, 12)).astype(np.float32)
    w = rng.normal(size=(ssm.CONV_K, 12)).astype(np.float32)
    st = rng.normal(size=(2, ssm.CONV_K - 1, 12)).astype(np.float32) if with_state else None
    out, new = ssm._causal_conv(_t(u), _t(w), None if st is None else _t(st))
    jout, jnew = jssm._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                   None if st is None else jnp.asarray(st))
    assert _rel_err(out.numpy(), jout) < 1e-5
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))


@pytest.mark.parametrize("chunk", [1, 8, 29, 64])
@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked_equals_jax_f32(chunk, initial):
    x, dt, A, Bm, Cm, S0 = _ssd_inputs()
    s0 = S0 if initial else None
    y, S = ssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                           initial_state=None if s0 is None else _t(s0))
    jy, jS = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
                              initial_state=None if s0 is None else jnp.asarray(s0))
    assert y.dtype == S.dtype == torch.float32
    assert _rel_err(y.numpy(), jy) < 1e-5
    assert _rel_err(S.numpy(), jS) < 1e-5


@pytest.mark.parametrize("chunk", [1, 8, 29, 64])
def test_ssd_chunked_equals_jax_bf16(chunk):
    """The JAX package's own bf16 error on these inputs (its bf16 scan
    against its f32 scan, relative to the largest output) measured
    1.1e-3-1.3e-3 over the four chunks; the port's bf16 scan against
    JAX's bf16 scan measured 0.8e-7-1.7e-7, held to 1e-5.  The boundary
    states stay f32 in both."""
    x, dt, A, Bm, Cm, S0 = _ssd_inputs(seed=1)
    j32 = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
                           initial_state=jnp.asarray(S0))
    jbf = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
                           initial_state=jnp.asarray(S0), compute_dtype=jnp.bfloat16)
    jax_err = _rel_err(jbf[0], j32[0])
    assert 5e-4 < jax_err < 3e-3, jax_err  # the rounding is really bf16's
    y, S = ssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                           initial_state=_t(S0), compute_dtype=torch.bfloat16)
    assert y.dtype == S.dtype == torch.float32
    assert _rel_err(y.numpy(), jbf[0]) < 1e-5
    assert _rel_err(S.numpy(), jbf[1]) < 1e-5


def test_ssd_sequential_equals_jax_and_the_chunked_scan():
    x, dt, A, Bm, Cm, S0 = _ssd_inputs(seed=2)
    y, S = ssm.ssd_sequential(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), _t(S0))
    jy, jS = jssm.ssd_sequential(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                                 initial_state=jnp.asarray(S0))
    assert _rel_err(y.numpy(), jy) < 1e-5 and _rel_err(S.numpy(), jS) < 1e-5
    for chunk in (1, 8, 29, 64):  # the JAX package's test, same bound
        yc, Sc = ssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                                 initial_state=_t(S0))
        np.testing.assert_allclose(yc.numpy(), y.numpy(), rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(Sc.numpy(), S.numpy(), rtol=3e-4, atol=3e-4)


def _block_params(cfg, seed):
    """Block weights with non-trivial gains (the init's are 0 and 1)."""
    rng = np.random.default_rng(seed)
    D, Di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "in_proj": (rng.normal(size=(D, 2 * Di + 2 * N + H)) / np.sqrt(D)).astype(np.float32),
        "out_proj": (rng.normal(size=(Di, D)) / np.sqrt(Di)).astype(np.float32),
        "conv_w": (rng.normal(size=(ssm.CONV_K, Di + 2 * N)) * 0.25).astype(np.float32),
        "A_log": rng.uniform(-1, 1, H).astype(np.float32),
        "D_skip": rng.uniform(0.5, 1.5, H).astype(np.float32),
        "dt_bias": rng.uniform(-1, 1, H).astype(np.float32),
        "norm": rng.uniform(0.5, 1.5, Di).astype(np.float32),
    }


@pytest.mark.parametrize("L", [1, 13, 40])
def test_ssm_block_equals_jax_with_and_without_the_cache(L):
    """The no-cache block (chunk 16: L 40 has a ragged tail) and the cached
    block (the prompt as one chunk, then a decode step on its states)."""
    cfg = configs.get_arch("mamba2-370m", smoke=True)
    jcfg = jconfigs.get_arch("mamba2-370m", smoke=True)
    p = _block_params(cfg, L)
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(L + 1)
    h = rng.normal(size=(2, L, cfg.d_model)).astype(np.float32)
    y, c = ssm.ssm_block_apply(tp, _t(h), cfg)
    jy, _ = jssm.ssm_block_apply(jp, jnp.asarray(h), jcfg)
    assert c is None and _rel_err(y.numpy(), jy) < 1e-5

    conv = rng.normal(size=(2, ssm.CONV_K - 1, cfg.d_inner + 2 * cfg.ssm_state))
    S = rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim))
    cache = {"conv": _t(conv), "S": _t(S)}
    jcache = {"conv": jnp.asarray(conv, jnp.float32), "S": jnp.asarray(S, jnp.float32)}
    y, c = ssm.ssm_block_apply(tp, _t(h), cfg, cache=cache)
    jy, jc = jssm.ssm_block_apply(jp, jnp.asarray(h), jcfg, cache=jcache)
    assert _rel_err(y.numpy(), jy) < 1e-5
    assert _rel_err(c["conv"].numpy(), jc["conv"]) < 1e-5  # the projection's last rows
    assert _rel_err(c["S"].numpy(), jc["S"]) < 1e-5
    h1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    y, c = ssm.ssm_block_apply(tp, _t(h1), cfg, cache=c)
    jy, jc = jssm.ssm_block_apply(jp, jnp.asarray(h1), jcfg, cache=jc)
    assert _rel_err(y.numpy(), jy) < 1e-5
    assert _rel_err(c["S"].numpy(), jc["S"]) < 1e-5


def test_bf16_block_keeps_the_jax_dtypes():
    """A bf16 block: output and conv state in bf16, the SSM state in f32,
    within the bf16 bound of the f32 block on the same weights."""
    cfg = dataclasses.replace(configs.get_arch("mamba2-370m", smoke=True),
                              dtype="bfloat16")
    p = _block_params(cfg, 7)
    t32 = {k: _t(v) for k, v in p.items()}
    tbf = {k: (v if k in ("A_log", "D_skip", "dt_bias") else v.to(torch.bfloat16))
           for k, v in t32.items()}
    h = _t(np.random.default_rng(8).normal(size=(2, 20, cfg.d_model)))
    zero = {"conv": torch.zeros((2, ssm.CONV_K - 1, cfg.d_inner + 2 * cfg.ssm_state),
                                dtype=torch.bfloat16),
            "S": torch.zeros((2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim))}
    y, c = ssm.ssm_block_apply(tbf, h.to(torch.bfloat16), cfg, cache=zero)
    y32, _ = ssm.ssm_block_apply(t32, h, cfg)
    assert y.dtype == c["conv"].dtype == torch.bfloat16 and c["S"].dtype == torch.float32
    assert _rel_err(y.float().numpy(), y32.numpy()) < 3e-2
