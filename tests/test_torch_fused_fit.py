"""Port parity, part 9: a whole single-column fit in one launch.

``csrc/fused_step.cu`` folds epochs x N volleys of D designs in one
launch (``fused_column.fused_fit_padded``); its plain version,
``fused_fit_padded_plain``, is a loop of the one-volley plain step.  Here
that plain fold is held against the JAX package's ``fit_fused`` (its
reference lowering, and its Pallas kernel run in interpret mode as the
JAX package's own tests run it) for int32 volleys, float volleys with
non-integer times and int32 volleys with negative times; the port's
``fit_fused(lowering='cuda')`` on CPU tensors against the plain fold; and
a PyTorch copy of the kernel's schedule (double-buffered volleys, the
slope histogram of the next volley scattered during STDP, wrapping from
the last volley of an epoch to the first of the next) against the plain
fold, bit for bit.  The kernel itself is held against the plain fold on
the card (``test_torch_cuda_kernels.py``).

Tolerance: trace and weights bit-equal wherever the integer grid makes
the arithmetic exact; against JAX, weights on the stabilizer path to the
reference's own rtol = atol = 1e-6, as the port's other parity tests
hold them.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import ColumnConfig as JColumn
from repro.core.types import NeuronConfig as JNeuron
from repro.core.types import STDPConfig as JSTDP
from repro.core.types import WTAConfig as JWTA
from repro.kernels import fused_column as jfc
from repro_torch.core.types import (
    ColumnConfig, NeuronConfig, STDPConfig, TIME_DTYPE, WTAConfig,
)
from repro_torch.kernels import fused_column, ref

W_MAX = 7


def _weights(rng, shape):
    """Half-integer grid plus off-grid jitter, in [0, w_max]: the rounding
    edges of the fire grid."""
    w = rng.integers(0, 2 * W_MAX + 1, shape).astype(np.float32) / 2
    jitter = rng.uniform(0, 0.3, shape).astype(np.float32) * (rng.random(shape) < 0.3)
    return np.clip(w + jitter, 0, W_MAX).astype(np.float32)


def _volleys(rng, kind, n, p, t_max):
    """int32 times in [0, t_max + 6) (silent ones included), the same
    shifted by a half (float, non-integer), or int32 times down to -8."""
    if kind == "int":
        return rng.integers(0, t_max + 6, (n, p)).astype(np.int32)
    if kind == "half":
        return (rng.integers(0, t_max + 6, (n, p)) + 0.5).astype(np.float32)
    return rng.integers(-8, t_max + 6, (n, p)).astype(np.int32)


# (p, q, N, epochs, t_max, wta_k, stabilize, volleys)
JAX_CASES = [
    (21, 3, 10, 2, 20, 1, True, "int"),
    (37, 5, 12, 3, 24, 2, False, "int"),
    (96, 6, 40, 2, 32, 1, False, "int"),
    (37, 5, 12, 2, 24, 1, True, "half"),
    (64, 2, 16, 3, 16, 2, False, "half"),
    (37, 5, 12, 2, 24, 2, True, "neg"),
    (50, 4, 20, 2, 20, 1, False, "neg"),
]


@pytest.mark.parametrize("lowering", ["reference", "interpret"])
@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "{}x{}_n{}_e{}_T{}_k{}_s{}_{}".format(
    *c[:6], int(c[6]), c[7]))
def test_plain_fold_matches_jax_fit_fused(case, lowering):
    p, q, n, epochs, t_max, k, stab, kind = case
    rng = np.random.default_rng(p * 31 + q + n)
    w0 = _weights(rng, (p, q))
    x = _volleys(rng, kind, n, p, t_max)
    thr = float(0.3 * p * 3.5 * t_max / 64)
    jcfg = JColumn(p=p, q=q, t_max=t_max, neuron=JNeuron(threshold=thr),
                   wta=JWTA(k=k), stdp=JSTDP(stabilizer="half" if stab else "none"))
    jp, jy = jfc.fit_fused({"w": jnp.asarray(w0)}, jnp.asarray(x), jcfg,
                           epochs=epochs, lowering=lowering, trace=True)
    ops = fused_column.design_operands([thr], [t_max], [q], jcfg.stdp.mu_capture,
                                       jcfg.stdp.mu_backoff, jcfg.stdp.mu_search)
    w, ys = fused_column.fused_fit_padded_plain(
        torch.from_numpy(w0)[None], torch.from_numpy(x)[None], ops, epochs=epochs,
        t_window=t_max, w_max=W_MAX, wta_k=k, stabilize=stab, trace=True)
    assert ys.shape == (1, epochs, n, q) and ys.dtype == TIME_DTYPE
    jy = np.asarray(jy)
    np.testing.assert_array_equal(ys[0].numpy(), jy)
    assert (jy < t_max).any()  # the case fires and learns
    jw = np.asarray(jp["w"])
    if stab:
        np.testing.assert_allclose(w[0].numpy(), jw, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(w[0].numpy(), jw)
    assert not np.array_equal(w[0].numpy(), w0)


def _cfg(p, q, t_max, thr, k, stab):
    return ColumnConfig(p=p, q=q, t_max=t_max, neuron=NeuronConfig(threshold=thr),
                        wta=WTAConfig(k=k),
                        stdp=STDPConfig(stabilizer="half" if stab else "none"))


@pytest.mark.parametrize("kind", ["int", "half", "neg"])
@pytest.mark.parametrize("k,stab", [(1, True), (2, False)])
def test_fit_fused_cuda_lowering_on_cpu_is_the_plain_fold(kind, k, stab):
    """``fit_fused(lowering='cuda')`` on CPU tensors takes the plain fold
    (one call, D = 1): bit-equal to it and to the reference lowering,
    weights and trace; ``params`` untouched."""
    p, q, n, t_max = 40, 4, 15, 24
    rng = np.random.default_rng(k * 7 + len(kind))
    w0 = _weights(rng, (p, q))
    x = torch.from_numpy(_volleys(rng, kind, n, p, t_max))
    cfg = _cfg(p, q, t_max, 0.3 * p * 3.5 * t_max / 64, k, stab)
    params = {"w": torch.from_numpy(w0.copy())}
    got, gy = fused_column.fit_fused(params, x, cfg, 3, "cuda", True)
    assert gy.shape == (3, n, q) and gy.dtype == TIME_DTYPE
    want, wy = fused_column.fit_fused(params, x, cfg, 3, "reference", True)
    assert torch.equal(gy, wy) and torch.equal(got["w"], want["w"])
    s = cfg.stdp
    ops = fused_column.design_operands([cfg.neuron.threshold], [t_max], [q],
                                       s.mu_capture, s.mu_backoff, s.mu_search)
    pw, py = fused_column.fused_fit_padded(
        params["w"][None], x[None], ops, epochs=3, t_window=t_max, w_max=W_MAX,
        wta_k=k, stabilize=stab, trace=True)
    assert torch.equal(py[0], gy) and torch.equal(pw[0], got["w"])
    np.testing.assert_array_equal(params["w"].numpy(), w0)
    # without the trace, and with no epoch at all
    nt, none = fused_column.fit_fused(params, x, cfg, 3, "cuda", False)
    assert none is None and torch.equal(nt["w"], got["w"])
    z, zy = fused_column.fit_fused(params, x, cfg, 0, "cuda", True)
    assert zy.shape == (0, n, q) and torch.equal(z["w"], params["w"])


def test_one_volley_step_is_the_fold_of_one_volley():
    """``fused_step_padded`` is the N = 1, one-epoch call of the folded
    kernel: its winner times are the fold's trace, as f32."""
    rng = np.random.default_rng(11)
    d, p, q = 3, 33, 5
    w = torch.from_numpy(_weights(rng, (d, p, q)))
    x = torch.from_numpy(rng.integers(0, 30, (d, p)).astype(np.int32))
    ops = fused_column.design_operands([20.0, 35.5, 8.0], [24, 19, 15], [5, 3, 1],
                                       0.5, 0.5, 1 / 1024)
    kw = dict(t_window=24, w_max=W_MAX, wta_k=2, stabilize=True)
    w1, y1 = fused_column.fused_step_padded(w, x, ops, **kw)
    wf, yf = fused_column.fused_fit_padded(w, x[:, None], ops, epochs=1, trace=True, **kw)
    assert y1.dtype == torch.float32 and torch.equal(y1.to(TIME_DTYPE), yf[:, 0, 0])
    assert torch.equal(w1, wf)


# ------------------------------------------------ the kernel's schedule
def _scatter(hist, t, g, live, t_end):
    """scatter_ramp for every live synapse: +1 at t_i, -1 at t_i + g_ij
    (dropped at or past t_end), nothing for a silent or negative time or
    g = 0.  hist [q, t_window + 1] int64; t [p]; g [p, q]."""
    p, q = g.shape
    ti = t.to(torch.int64)[:, None].expand(p, q)
    gi = g.to(torch.int64)
    j = torch.arange(q)[None, :].expand(p, q)
    up = (ti >= 0) & (ti < t_end) & (gi > 0) & live[None, :]
    hist.index_put_((j[up], ti[up]), torch.ones(int(up.sum()), dtype=torch.int64),
                    accumulate=True)
    down = up & (ti + gi < t_end)
    hist.index_put_((j[down], (ti + gi)[down]),
                    -torch.ones(int(down.sum()), dtype=torch.int64), accumulate=True)


def _scan_fire(hist, threshold, t_end):
    """warp_scan_fire_time for every row: the first t < t_end with
    V(t) >= threshold (V(0) = 0), else t_end; the rows left zeroed."""
    q = hist.shape[0]
    slope = torch.cumsum(hist[:, :t_end], dim=1)
    v = torch.cat([torch.zeros((q, 1), dtype=torch.int64),
                   torch.cumsum(slope, dim=1)[:, : t_end - 1]], dim=1)
    hit = v.to(torch.float32) >= threshold
    first = torch.where(hit.any(dim=1), hit.to(torch.int64).argmax(dim=1),
                        torch.full((q,), t_end))
    hist.zero_()
    return first


def kernel_schedule(w, xs, ops, *, epochs, t_window, w_max, wta_k, stabilize):
    """The folded kernel's schedule on the CPU, design by design, in its
    order: volleys through a two-slot buffer (v and v + 1 loaded first,
    v + 2 into v's slot once v's STDP has read it); in the slope form the
    first volley scattered from the loaded weights and each next volley's
    ramps scattered with the weights that STDP just wrote, the next volley
    of the last one of an epoch being the first of the next epoch, and
    nothing after the last volley of the fit.  Each design takes the
    slope form where its volleys are int32 with every time >= 0 (the
    form's exact domain), else the ramp sum, as each thread block decides
    for its own design.  Returns (w, trace [D, epochs, N, q]) as the
    kernel writes them."""
    d_n, n, p = xs.shape
    q = w.shape[2]
    total = epochs * n
    trace = torch.zeros(d_n * total * q, dtype=TIME_DTYPE)
    out = []
    for d in range(d_n):
        thr, tm, qa, mc, mb, ms = (float(v) for v in ops[d])
        slope = xs.dtype == TIME_DTYPE and bool((xs[d] >= 0).all())
        t_end, t_cap = min(t_window, math.ceil(tm)), int(tm)
        live = torch.arange(q) < qa
        buf = [None, None]

        def prefetch(v, slot):
            buf[slot] = xs[d, v % n].clone()

        if total > 0:
            prefetch(0, 0)
        if total > 1:
            prefetch(1, 1)
        hist = torch.zeros((q, t_window + 1), dtype=torch.int64)
        sw = w[d].clone()

        def grid(v):
            return torch.round(torch.clamp(v, 0.0, float(w_max)))

        if slope and total > 0:
            _scatter(hist, buf[0], grid(sw), live, t_end)
        for v in range(total):
            ti, tn = buf[v & 1], buf[(v + 1) & 1]
            if slope:
                t = _scan_fire(hist, thr, t_end)
            else:
                t = fused_column.fire_dense_ref(grid(sw), ti, thr, t_window, tm)
            t = torch.where(live, torch.clamp(t.to(torch.int64), max=t_cap), t_cap)
            y = fused_column._wta_min_rounds(t.to(torch.float32)[None],
                                             torch.tensor([[tm]]), wta_k)[0]
            trace[(d * total + v) * q : (d * total + v + 1) * q] = y.to(TIME_DTYPE)
            new = ref.stdp_ref(sw, ti.to(torch.float32), y, mc, mb, ms, w_max, tm,
                               stabilize=stabilize, compiled=True)
            sw = torch.where(live[None, :], new, sw)
            if slope and v + 1 < total:
                _scatter(hist, tn, grid(sw), live, t_end)
            if v + 2 < total:
                prefetch(v + 2, v & 1)
        out.append(sw)
    return torch.stack(out), trace.reshape(d_n, epochs, n, q)


@pytest.mark.parametrize("kind", ["int", "half", "neg", "mixed"])
@pytest.mark.parametrize("n", [1, 7, 33])
def test_kernel_schedule_equals_the_plain_fold(n, kind):
    """Heterogeneous designs (t_max < t_window, q_active < q, a threshold
    0 design), three epochs: the schedule's weights and trace equal the
    plain fold's bit for bit, across every epoch boundary.  ``mixed``:
    int32 volleys with negative times in design 0 only, so one launch
    fires design 0 by the ramp sum and the others by the slope form."""
    rng = np.random.default_rng(n * 5 + len(kind))
    d, p, q, t_window = 3, 29, 6, 24
    w = torch.from_numpy(_weights(rng, (d, p, q)))
    kinds = ["neg", "int", "int"] if kind == "mixed" else [kind] * d
    xs = torch.from_numpy(np.stack([_volleys(rng, k, n, p, t_window) for k in kinds]))
    if kind == "mixed":
        assert (xs[0] < 0).any() and (xs[1:] >= 0).all()
    ops = fused_column.design_operands(
        [0.25 * p * 3.5 * 24 / 64, 0.0, 0.35 * p * 3.5 * 24 / 64],
        [t_window, 17, t_window], [q, q, q - 2], [0.5, 1.0, 0.25], 0.5,
        [1 / 1024, 0.5, 1 / 1024])
    kw = dict(epochs=3, t_window=t_window, w_max=W_MAX, wta_k=2, stabilize=True)
    want_w, want_y = fused_column.fused_fit_padded_plain(w, xs, ops, trace=True, **kw)
    got_w, got_y = kernel_schedule(w, xs, ops, **kw)
    assert torch.equal(got_y, want_y)
    assert torch.equal(got_w, want_w), (got_w - want_w).abs().max()
    assert not torch.equal(got_w, w)
