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
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.kernels import causal_conv as conv_lib
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


# ------------------------------------------------- the conv's kernel dispatch
BF, F32, F64 = torch.bfloat16, torch.float32, torch.float64


def _conv_counts():
    k = build.CAUSAL_CONV
    return (k.launches, k.builds, k.binds)


def _refuse(*a, **k):
    raise AssertionError("the kernel's wrapper was called")


def _conv_operands(dtype, b=2, L=9, di=64, gn=16, heads=4, state=True, bias=True,
                   device="cpu", seed=0):
    """The conv's operands as ``ssm_block_apply`` passes them: u the x | B | C
    columns of an in_proj output [b, L, 2 di + 2 gn + heads] (a strided
    view), w [CONV_K, C], a state [b, CONV_K - 1, C] and a bias [C]."""
    g = torch.Generator().manual_seed(seed)
    c = di + 2 * gn
    shapes = ((b, L, di + c + heads), (ssm.CONV_K, c), (b, ssm.CONV_K - 1, c), (c,))
    if device == "cpu":
        proj, w, st, bi = (torch.randn(s, generator=g).to(dtype) for s in shapes)
    else:  # fake CUDA tensors (a fake CPU tensor cannot move without CUDA)
        proj, w, st, bi = (torch.empty(s, dtype=dtype, device=device) for s in shapes)
    u = torch.split(proj, [di, c, heads], dim=-1)[1]
    return u, w, st if state else None, bi if bias else None


@pytest.mark.parametrize("dtype", [F32, BF, F64], ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_causal_conv_on_cpu_runs_the_plain_body(monkeypatch, dtype, state, bias):
    """CPU tensors take ``_causal_conv_plain``, bit for bit, and touch no
    kernel object."""
    before = _conv_counts()
    monkeypatch.setattr(conv_lib, "causal_conv", _refuse)
    ops = _conv_operands(dtype, state=state, bias=bias)
    got = ssm._causal_conv(*ops)
    want = ssm._causal_conv_plain(*ops)
    assert got[0].dtype == got[1].dtype == dtype
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _conv_counts() == before


# (dtype, w requires grad, grad mode, the kernel runs)
CONV_DISPATCH = [
    (BF, False, True, True),
    (F32, False, True, True),
    (F64, False, True, False),   # float64: the plain body
    (F32, True, True, False),    # autograd: the plain body
    (BF, True, True, False),
    (F32, True, False, True),    # requires grad, but under no_grad
]


@pytest.mark.parametrize("dtype,req,grad,kernel", CONV_DISPATCH,
                         ids=["bf16", "f32", "f64", "f32_grad", "bf16_grad", "f32_no_grad"])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
def test_causal_conv_dispatch_on_cuda_tensors(monkeypatch, dtype, req, grad, kernel, state):
    """On (fake) CUDA tensors: bf16 and f32 without a gradient go to the
    kernel's wrapper with ``_causal_conv``'s arguments; float64 and
    autograd go to the plain body; neither path builds anything here."""
    calls = []
    monkeypatch.setattr(conv_lib, "causal_conv", lambda *a: calls.append(("kernel", a)))
    monkeypatch.setattr(ssm, "_causal_conv_plain", lambda *a: calls.append(("plain", a)))
    before = _conv_counts()
    with FakeTensorMode():
        u, w, st, bi = _conv_operands(dtype, state=state, device="cuda")
        w.requires_grad_(req)
        with torch.set_grad_enabled(grad):
            ssm._causal_conv(u, w, st, bi)
    assert [c[0] for c in calls] == ["kernel" if kernel else "plain"]
    assert calls[0][1] == (u, w, st, bi)
    assert _conv_counts() == before


@pytest.mark.parametrize("dtype", [F32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_causal_conv_plain_on_the_in_proj_view_equals_the_copy(dtype, state, bias):
    """The plain conv reads the in_proj output's x | B | C columns in place
    (the view ``ssm_block_apply`` now passes, in place of the concatenated
    copy) and gives the copy's result, bit for bit."""
    u, w, st, bi = _conv_operands(dtype, L=13, state=state, bias=bias, seed=3)
    assert not u.is_contiguous()
    got = ssm._causal_conv_plain(u, w, st, bi)
    want = ssm._causal_conv_plain(u.contiguous(), w, st, bi)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("L", [1, 2, 3, 5])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
def test_causal_conv_new_state_is_the_last_rows_of_the_concatenation(L, state):
    """new_state is the last K-1 rows of concat(state, u): for L < K-1 it
    mixes the state's rows (zeros without a state) and u's."""
    u, w, st, bi = _conv_operands(BF, L=L, state=state, seed=L)
    _, new = ssm._causal_conv(u, w, st, bi)
    prev = st if state else torch.zeros((u.shape[0], ssm.CONV_K - 1, u.shape[2]), dtype=BF)
    assert torch.equal(new, torch.cat([prev, u], dim=1)[:, -(ssm.CONV_K - 1):])


def test_causal_conv_plain_is_the_tap_order_sum_in_f32():
    """The plain conv's arithmetic, the kernel's specification: per element
    (((0 + u[t-3] w0) + u[t-2] w1) + u[t-1] w2) + u[t] w3 in f32, + bias,
    PyTorch's SiLU, rounded to bf16."""
    u, w, st, bi = _conv_operands(BF, L=6, seed=9)
    out, _ = ssm._causal_conv_plain(u, w, st, bi)
    full = torch.cat([st, u], dim=1).float()
    wf = w.float()
    for t in range(u.shape[1]):
        acc = torch.zeros(u.shape[0], u.shape[2])
        for k in range(ssm.CONV_K):
            acc = acc + full[:, t + k] * wf[k]
        acc = acc + bi.float()
        assert torch.equal(out[:, t], torch.nn.functional.silu(acc).to(BF))


@pytest.mark.parametrize("dtype", [F32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ["zamba2-7b-instruct", "zamba2-7b", "mamba2-370m"])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_causal_conv_takes_8_byte_accesses_at_the_port_widths(dtype, arch, smoke):
    """The in_proj view of every SSM configuration of the port, full and
    smoke, in bf16 and in f32, takes the kernel's 8-byte path; an odd
    width, or a view one element off, the one-element path."""
    cfg = configs.get_arch(arch, smoke=smoke)
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    u, w, st, bi = _conv_operands(dtype, b=2, L=3, di=di, gn=gn, heads=cfg.ssm_heads)
    assert conv_lib.vectorized(u, w, st, bi)
    assert conv_lib.vectorized(u, w, None, None)
    odd, wo, so, bo = _conv_operands(dtype, b=2, L=3, di=61, gn=9, heads=3)
    assert not conv_lib.vectorized(odd, wo, so, bo)
    assert not conv_lib.vectorized(u[..., 1:], w[:, 1:], st[..., 1:], bi[1:])


def test_causal_conv_wrapper_refuses_before_building():
    """The wrapper's checks raise ValueError, before anything is built or
    launched, for CPU tensors, mixed devices, other dtypes, wrong shapes
    and a strided innermost dim."""
    before = _conv_counts()
    conv = conv_lib.causal_conv
    u, w, st, bi = _conv_operands(F32)
    with pytest.raises(ValueError, match="one CUDA device"):
        conv(u, w, st, bi)
    with FakeTensorMode():
        u, w, st, bi = _conv_operands(BF, device="cuda")
        c = u.shape[2]

        def cuda(shape, dtype=BF, stride=None):  # (slicing a fake CUDA tensor needs CUDA)
            if stride is None:
                return torch.empty(shape, dtype=dtype, device="cuda")
            return torch.empty_strided(shape, stride, dtype=dtype, device="cuda")

        with pytest.raises(ValueError, match="one CUDA device"):
            conv(u, w, st, torch.zeros((c,), dtype=BF))  # the bias on the CPU
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            conv(cuda(u.shape, F64), w.double(), st.double(), bi.double())
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            conv(u, cuda(w.shape, F32), st, bi)  # f32 taps on bf16 rows
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            conv(u, w, cuda(st.shape, F32), bi)
        with pytest.raises(ValueError, match=r"u \[B, L >= 1, C\]"):
            conv(cuda((9, c)), w, None, bi)
        with pytest.raises(ValueError, match=r"u \[B, L >= 1, C\]"):
            conv(cuda((2, 0, c)), w, st, bi)
        with pytest.raises(ValueError, match="needs w"):
            conv(u, cuda((3, c)), st, bi)
        with pytest.raises(ValueError, match="needs w"):
            conv(u, w, st, cuda((c + 1,)))
        with pytest.raises(ValueError, match="needs w"):
            conv(u, w, cuda((2, 4, c)), bi)
        with pytest.raises(ValueError, match="needs w"):
            conv(u, w, cuda((1, 3, c)), bi)
        with pytest.raises(ValueError, match="innermost stride"):
            conv(cuda((2, 9, c), BF, (18 * c, 2 * c, 2)), w, st, bi)
    assert _conv_counts() == before


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


# ---------------------------------------------- the decode step's dispatch
STEP_ARCHS = ["zamba2-7b-instruct", "granite-4.0-h-small", "mamba2-370m"]


def _step_counts():
    k = build.SSM_STEP
    return (k.launches, k.builds, k.binds)


def _fake_step_operands(cfg, dtype, b=2):
    """``_one_token``'s operands as fake CUDA tensors, at ``cfg``'s widths:
    the block's weights, an in_proj output [b, 1, W] and the states."""
    H, G, N, dh = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    di = H * dh
    c = di + 2 * G * N

    def e(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="cuda")

    params = {"conv_w": e(ssm.CONV_K, c), "A_log": e(H, dt=F32), "D_skip": e(H, dt=F32),
              "dt_bias": e(H, dt=F32), "norm": e(di), "out_proj": e(di, cfg.d_model)}
    if cfg.conv_bias:
        params["conv_b"] = e(c)
    cache = {"conv": e(b, ssm.CONV_K - 1, c), "S": e(b, H, N, dh, dt=F32)}
    return params, e(b, 1, di + c + H), cache


@pytest.mark.parametrize("dtype", [F32, BF, F64], ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_one_token_on_cpu_runs_the_plain_body(monkeypatch, dtype, arch):
    """CPU tensors take ``_one_token_plain``, bit for bit, and touch no
    kernel object."""
    from repro_torch.kernels import ssm_step as step_lib
    from repro_torch.testing import ssm_step as step_test

    before = _step_counts()
    monkeypatch.setattr(step_lib, "ssm_step", _refuse)
    cfg = configs.get_arch(arch, smoke=True)
    p, proj, cache = step_test.step_inputs(cfg, 2, BF if dtype == BF else F32, "cpu", seed=5)
    if dtype == F64:
        p = {k: v.double() for k, v in p.items()}
        proj, cache = proj.double(), {k: v.double() for k, v in cache.items()}
    y, new = ssm._one_token(p, proj, cfg, cache)
    want, want_new = ssm._one_token_plain(p, proj, cfg, cache)
    assert y.dtype == new["conv"].dtype == dtype
    assert torch.equal(y, want) and all(torch.equal(new[k], want_new[k]) for k in new)
    assert _step_counts() == before


@pytest.mark.parametrize("dtype,req,grad,kernel", CONV_DISPATCH,
                         ids=["bf16", "f32", "f64", "f32_grad", "bf16_grad", "f32_no_grad"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_one_token_dispatch_on_cuda_tensors(monkeypatch, dtype, req, grad, kernel, arch):
    """On (fake) CUDA tensors: bf16 and f32 without a gradient go to the
    kernels' wrapper with the config's groups, clamp, norm and eps, and its
    y goes through out_proj; float64 and autograd go to the plain body;
    neither path builds anything here."""
    from repro_torch.kernels import ssm_step as step_lib

    cfg = configs.get_arch(arch)
    calls = []

    def kernel_stub(*a, **kw):
        calls.append(("kernel", a, kw))
        b, di = a[0].shape[0], a[-1].shape[0]
        return (torch.empty((b, 1, di), dtype=a[0].dtype, device="cuda"), a[1], a[2])

    monkeypatch.setattr(step_lib, "ssm_step", kernel_stub)
    monkeypatch.setattr(ssm, "_one_token_plain", lambda *a: calls.append(("plain", a)))
    before = _step_counts()
    with FakeTensorMode():
        p, proj, cache = _fake_step_operands(cfg, dtype)
        p["in_proj"] = torch.empty((1,), device="cuda").requires_grad_(True)  # not read
        p["conv_w"].requires_grad_(req)
        with torch.set_grad_enabled(grad):
            out = ssm._one_token(p, proj, cfg, cache)
    assert [c[0] for c in calls] == ["kernel" if kernel else "plain"]
    if kernel:
        _, args, kw = calls[0]
        assert args == (proj, cache["conv"], cache["S"], p["conv_w"], p.get("conv_b"),
                        p["dt_bias"], p["A_log"], p["D_skip"], p["norm"])
        grouped = cfg.ssm_norm == "grouped"
        assert kw == dict(groups=cfg.ssm_groups, dt_min=cfg.dt_min, norm=cfg.ssm_norm,
                          eps=cfg.norm_eps if grouped else ssm.RMSNORM_EPS)
        assert out[0].shape == (2, 1, cfg.d_model)
        assert out[1]["conv"] is cache["conv"] and out[1]["S"] is cache["S"]
    else:
        assert calls[0][1] == (p, proj, cfg, cache)
    assert _step_counts() == before


@pytest.mark.parametrize("dtype", [F32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_one_token_writes_nothing_into_its_cache(dtype, arch):
    """The states passed in are read, never written: the cache is the same
    after the step, and the new states are other tensors."""
    from repro_torch.testing import ssm_step as step_test

    cfg = configs.get_arch(arch, smoke=True)
    p, proj, cache = step_test.step_inputs(cfg, 3, dtype, "cpu", seed=7)
    kept = {k: v.clone() for k, v in cache.items()}
    _, new = ssm._one_token(p, proj, cfg, cache)
    assert all(torch.equal(cache[k], kept[k]) for k in cache)
    assert all(new[k].data_ptr() != cache[k].data_ptr() for k in cache)
    assert not torch.equal(new["S"], kept["S"])


@pytest.mark.parametrize("fault", ["a decode step reads a stale conv state",
                                   "a decode step reads a stale SSM state"])
@pytest.mark.parametrize("arch", ["zamba2-7b-instruct", "granite-4.0-h-small"])
def test_lm_faults_decode_faults_still_change_one_token(monkeypatch, fault, arch):
    """``nspubench.lm_faults`` plants its two decode faults by wrapping
    ``ssm._one_token``: at the smoke size each still changes what a decode
    step through ``ssm_block_apply`` returns (the stale conv state y, the
    stale SSM state the new state), so the dispatch inside ``_one_token``
    left them armed."""
    from nspubench import lm_faults
    from repro_torch.testing import ssm_step as step_test

    cfg = configs.get_arch(arch, smoke=True)
    p, _, cache = step_test.step_inputs(cfg, 2, F32, "cpu", seed=11)
    p["in_proj"] = 0.3 * torch.randn((cfg.d_model, p["conv_w"].shape[1] + cfg.d_inner
                                      + cfg.ssm_heads), generator=torch.Generator().manual_seed(1))
    h = torch.randn((2, 1, cfg.d_model), generator=torch.Generator().manual_seed(2))
    y, new = ssm.ssm_block_apply(p, h, cfg, cache=cache)
    lm_faults.plant(fault, monkeypatch.setattr)
    y2, new2 = ssm.ssm_block_apply(p, h, cfg, cache=cache)
    if "conv" in fault:
        assert _rel_err(y2, y) > 1e-3
    else:
        assert torch.equal(y2, y) and _rel_err(new2["S"], new["S"]) > 1e-3


@pytest.mark.parametrize("dtype", [F32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch,smoke,b", [("zamba2-7b-instruct", False, 2),
                                          ("granite-4.0-h-small", False, 1),
                                          ("mamba2-370m", False, 2),
                                          ("mamba2-370m", True, 3),
                                          ("zamba2-7b-instruct", True, 3)])
def test_ssm_step_twin_holds_the_bound_a_fault_does_not(dtype, arch, smoke, b):
    """A CPU copy of the kernels' arithmetic (``testing.ssm_step.twin``: y =
    C . S' in the kernel's order) against ``_one_token_plain``: the states
    bit-equal, y within the card tests' per-element bound; the plain body
    with the D skip dropped reads far over it."""
    from repro_torch.testing import ssm_step as step_test

    cfg = configs.get_arch(arch, smoke=smoke)
    p, proj, cache = step_test.step_inputs(cfg, b, dtype, "cpu", seed=b)
    want = ssm._one_token_plain(p, proj, cfg, cache)
    r = step_test.agreement(step_test.twin(p, proj, cfg, cache), want, p, proj, cfg, cache)
    assert step_test.holds(r), r
    bad = ssm._one_token_plain(dict(p, D_skip=0 * p["D_skip"]), proj, cfg, cache)
    assert step_test.agreement(bad, want, p, proj, cfg, cache)["ratio"] > 100


@pytest.mark.parametrize("arch", ["zamba2-7b-instruct", "granite-4.0-h-small", "zamba2-7b",
                                  "mamba2-370m"])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_ssm_step_takes_every_ssm_config_of_the_port(arch, smoke):
    """Every SSM configuration of the port, full and smoke, is in the
    kernels' range (a head dim a multiple of 4, at most 512; the shared
    memory under 48 KB), so none raises on the card."""
    from repro_torch.kernels import ssm_step as step_lib

    cfg = configs.get_arch(arch, smoke=smoke)
    dh = cfg.ssm_head_dim
    assert dh % 4 == 0 and 4 <= dh <= 4 * step_lib.THREADS
    assert step_lib.smem_bytes(cfg.ssm_state, dh) <= step_lib.MAX_SMEM_BYTES
    assert cfg.ssm_heads % cfg.ssm_groups == 0 and cfg.ssm_norm in step_lib.NORMS


def test_ssm_step_wrapper_refuses_before_building():
    """The wrapper's checks raise ValueError, before anything is built or
    launched, for CPU tensors, mixed devices, other dtypes, wrong shapes,
    an unknown norm and a strided proj or S."""
    from repro_torch.kernels import ssm_step as step_lib

    before = _step_counts()
    cfg = configs.get_arch("zamba2-7b-instruct", smoke=True)
    kw = dict(groups=cfg.ssm_groups, dt_min=cfg.dt_min, norm="grouped", eps=1e-5)
    keys = ("conv_w", "conv_b", "dt_bias", "A_log", "D_skip", "norm")

    def call(p, proj, cache, **over):
        return step_lib.ssm_step(proj, cache["conv"], cache["S"], *(p[k] for k in keys),
                                 **dict(kw, **over))

    from repro_torch.testing import ssm_step as step_test

    p, proj, cache = step_test.step_inputs(cfg, 2, BF, "cpu")
    with pytest.raises(ValueError, match="one CUDA device"):
        call(p, proj, cache)
    with FakeTensorMode():
        p, proj, cache = _fake_step_operands(cfg, BF)
        H, N, dh = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim

        def cuda(shape, dtype=BF, stride=None):
            if stride is None:
                return torch.empty(shape, dtype=dtype, device="cuda")
            return torch.empty_strided(shape, stride, dtype=dtype, device="cuda")

        with pytest.raises(ValueError, match="one CUDA device"):
            call(dict(p, norm=torch.zeros(p["norm"].shape, dtype=BF)), proj, cache)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            call({k: v.double() if v.dtype == BF else v for k, v in p.items()},
                 cuda(proj.shape, F64), dict(cache, conv=cuda(cache["conv"].shape, F64)))
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            call(dict(p, conv_w=cuda(p["conv_w"].shape, F32)), proj, cache)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            call(p, proj, dict(cache, S=cuda(cache["S"].shape, BF)))
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            call(dict(p, A_log=cuda((H,), BF)), proj, cache)
        with pytest.raises(ValueError, match="not one of"):
            call(p, proj, cache, norm="layernorm")
        with pytest.raises(ValueError, match=r"S \[B, H, N, dh\]"):
            call(p, cuda((2, 2, proj.shape[-1])), cache)
        with pytest.raises(ValueError, match="needs"):
            call(p, cuda((2, 1, proj.shape[-1] + 1)), cache)
        with pytest.raises(ValueError, match="needs"):
            call(dict(p, conv_b=cuda((p["conv_b"].shape[0] - 1,))), proj, cache)
        with pytest.raises(ValueError, match="needs"):
            call(p, proj, cache, groups=3)
        with pytest.raises(ValueError, match="head dim"):
            call(p, proj, dict(cache, S=cuda((2, H, N * 2, dh // 2 + 2), F32)),
                 groups=cfg.ssm_groups)
        with pytest.raises(ValueError, match="innermost stride"):
            w = proj.shape[-1]
            call(p, cuda((2, 1, w), BF, (2 * w, 2 * w, 2)), cache)
        with pytest.raises(ValueError, match="contiguous"):
            call(p, proj, dict(cache, S=cuda((2, H, N, dh), F32, (H * N * dh, N * dh, 1, N))))
    assert _step_counts() == before
