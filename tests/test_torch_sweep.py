"""Port parity, part 5: the padded design sweep.

The JAX package and the port run the same numpy-seeded inputs on the CPU:
the padded training scan (``fit_scan_padded``) against JAX's reference
lowering and its interpreted volley-block kernel, the batched assignment
(``assign_padded``) on float and integer-grid weights, the bucket policy,
and ``cluster_time_series_many`` end to end, including its fault-isolated
mode.  On the CPU the port's kernel wrappers take their plain versions;
the kernels themselves are held against those on the card
(``tests/test_torch_cuda_kernels.py``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import simulator as jsim
from repro.core.types import ColumnConfig as JColumn
from repro.core.types import STDPConfig as JSTDP
from repro.kernels import fused_column as jfc
from repro.roofline import costmodel as jcostmodel
from repro_torch.core import backend, simulator
from repro_torch.core.types import ColumnConfig, STDPConfig
from repro_torch.data import ucr
from repro_torch.kernels import build, fused_column
from repro_torch.roofline import costmodel

GRID_MUS = dict(mu_capture=1.0, mu_backoff=1.0, mu_search=1.0)
PAPER_MUS = dict(mu_capture=0.5, mu_backoff=0.5, mu_search=1 / 1024)


def padded_batch(seed=0, d=3, p_pad=20, q_pad=5, t_window=24, n=7, grid=True):
    """Heterogeneous designs in one envelope (the JAX package's
    ``tests/test_blocked_scan.py`` batch); n=7 so that no block size
    divides the stream.  ``grid=False`` moves the weights off the grid."""
    rng = np.random.default_rng(seed)
    th = np.asarray([7.0, 4.0, 5.0][:d], np.float32)
    tm = np.asarray([24, 12, 20][:d], np.int32)
    qa = np.asarray([5, 2, 3][:d], np.int32)
    w = rng.integers(0, 8, (d, p_pad, q_pad)).astype(np.float32)
    if not grid:
        w = np.clip(w + rng.uniform(0, 1, w.shape).astype(np.float32), 0, 7)
    xs = rng.integers(0, 28, (n, d, p_pad)).astype(np.int32)
    return w, xs, th, tm, qa, t_window


def _fit_args(stabilize, wta_k=1, epochs=2, t_window=24):
    mus = PAPER_MUS if stabilize else GRID_MUS
    return dict(t_window=t_window, w_max=7, wta_k=wta_k, stabilize=stabilize,
                response="rnl", epochs=epochs, **mus)


def _jax_fit(lowering, w, xs, th, tm, qa, v_blk, **args):
    return np.asarray(jfc.fit_scan_padded(
        jnp.asarray(w), jnp.asarray(xs), jnp.asarray(th), jnp.asarray(tm),
        jnp.asarray(qa), lowering=lowering, v_blk=v_blk, **args))


def _port_fit(lowering, w, xs, th, tm, qa, v_blk, **args):
    return fused_column.fit_scan_padded(
        torch.from_numpy(w), torch.from_numpy(xs), th, tm, qa,
        lowering=lowering, v_blk=v_blk, **args).numpy()


# ------------------------------------------------------- padded training
def test_compiled_stabilizer_equals_jitted_jax_stdp():
    """Under jit, XLA computes the stabilizer as w * f32(1/w_max) and
    f32(1 + eps) - frac; ``compiled=True`` is that form, bit for bit, and
    differs from the source's division somewhere on this input."""
    import jax

    from repro.kernels import ref as jref
    from repro_torch.kernels import ref

    rng = np.random.default_rng(0)
    w = rng.uniform(0, 7, (200, 50)).astype(np.float32)
    x = rng.integers(0, 30, 200).astype(np.int32)
    y = rng.integers(0, 30, 50).astype(np.int32)
    jitted = jax.jit(lambda w, x, y: jref.stdp_ref(w, x, y, 0.5, 0.5, 1 / 1024, 7, 24))
    j = np.asarray(jitted(w, x, y))
    args = (torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(y),
            0.5, 0.5, 1 / 1024, 7, 24)
    np.testing.assert_array_equal(ref.stdp_ref(*args, compiled=True).numpy(), j)
    assert not np.array_equal(ref.stdp_ref(*args).numpy(), j)


@pytest.mark.parametrize("stabilize,wta_k", [(False, 1), (False, 2), (True, 1), (True, 2)])
def test_fit_scan_padded_bit_equal_to_jax_reference(stabilize, wta_k):
    w, xs, th, tm, qa, _ = padded_batch(seed=wta_k, grid=not stabilize)
    args = _fit_args(stabilize, wta_k)
    j = _jax_fit("reference", w, xs, th, tm, qa, 3, **args)
    for lowering in ("reference", "cuda"):  # 'cuda' on CPU tensors: the plain block
        got = _port_fit(lowering, w, xs, th, tm, qa, 3, **args)
        np.testing.assert_array_equal(got, j, err_msg=lowering)


@pytest.mark.parametrize("stabilize", [False, True])
def test_fit_scan_padded_matches_interpreted_block_kernel(stabilize):
    w, xs, th, tm, qa, _ = padded_batch(seed=4, grid=not stabilize)
    args = _fit_args(stabilize, wta_k=2)
    j = _jax_fit("interpret", w, xs, th, tm, qa, 3, **args)
    got = _port_fit("cuda", w, xs, th, tm, qa, 3, **args)
    if stabilize:  # the JAX package's own cross-lowering bound
        np.testing.assert_allclose(got, j, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, j)


@pytest.mark.parametrize("stabilize", [False, True])
@pytest.mark.parametrize("v_blk", [2, 3, 5, 7, 8, 16, 32])
def test_fit_scan_padded_same_for_every_block_size(stabilize, v_blk):
    w, xs, th, tm, qa, _ = padded_batch(seed=7, grid=not stabilize)
    args = _fit_args(stabilize)
    w1 = _port_fit("reference", w, xs, th, tm, qa, 1, **args)
    np.testing.assert_array_equal(
        _port_fit("reference", w, xs, th, tm, qa, v_blk, **args), w1)


def test_block_tail_is_masked_for_degenerate_thresholds():
    """threshold 0 fires every neuron of a silent volley at t=0, so only
    the valid count keeps the silent block tail out of the fold."""
    rng = np.random.default_rng(11)
    w = rng.integers(1, 8, (1, 8, 3)).astype(np.float32)
    xs = rng.integers(0, 10, (3, 1, 8)).astype(np.int32)
    th, tm, qa = np.float32([0.0]), np.int32([10]), np.int32([3])
    args = _fit_args(False, epochs=1, t_window=10)
    j = _jax_fit("reference", w, xs, th, tm, qa, 1, **args)
    for v_blk in (1, 2, 4):
        for lowering in ("reference", "cuda"):
            np.testing.assert_array_equal(
                _port_fit(lowering, w, xs, th, tm, qa, v_blk, **args), j,
                err_msg=f"{lowering} v_blk={v_blk}")
    # without the mask the tail would have moved the weights
    blk = torch.full((1, 2, 8), 10.0)
    blk[0, 0] = torch.from_numpy(xs[2, 0].astype(np.float32))
    ops = fused_column.design_operands([0.0], [10], [3], 1.0, 1.0, 1.0)
    kw = dict(t_window=10, w_max=7, wta_k=1, stabilize=False)
    w0 = torch.from_numpy(w)
    masked = fused_column.fused_block_padded(w0, blk, ops, 1, **kw)
    unmasked = fused_column.fused_block_padded(w0, blk, ops, 2, **kw)
    assert not torch.equal(masked, unmasked)


def test_fit_scan_padded_guards_and_snl():
    w, xs, th, tm, qa, _ = padded_batch()
    args = _fit_args(False)
    with pytest.raises(ValueError, match="empty"):
        _port_fit("reference", w, xs[:0], th, tm, qa, 3, **args)
    w0 = torch.from_numpy(w)
    same = fused_column.fit_scan_padded(
        w0, torch.from_numpy(xs), th, tm, qa, v_blk=3, **dict(args, epochs=0))
    assert same is w0
    with pytest.raises(ValueError, match="unknown lowering"):
        _port_fit("mosaic", w, xs, th, tm, qa, 3, **args)
    snl = dict(args, response="snl")
    with pytest.raises(ValueError, match="response"):
        _port_fit("cuda", w, xs, th, tm, qa, 3, **snl)
    np.testing.assert_array_equal(
        _port_fit("reference", w, xs, th, tm, qa, 3, **snl),
        _jax_fit("reference", w, xs, th, tm, qa, 3, **snl))


def test_wrappers_on_cpu_tensors_take_the_plain_versions():
    w, xs, th, tm, qa, t_window = padded_batch()
    ops = fused_column.design_operands(th, tm, qa, 1.0, 1.0, 1.0)
    blk = torch.from_numpy(xs[:4].transpose(1, 0, 2).astype(np.float32)).contiguous()
    kw = dict(t_window=t_window, w_max=7, wta_k=1, stabilize=False)
    before = (build.FUSED_BLOCK.launches, build.FIRE_BLOCK.launches)
    wt = torch.from_numpy(w)
    assert torch.equal(fused_column.fused_block_padded(wt, blk, ops, 3, **kw),
                       fused_column.fused_block_padded_plain(wt, blk, ops, 3, **kw))
    assert torch.equal(
        fused_column.fire_block_padded(wt, blk, ops, t_window=t_window, w_max=7),
        fused_column.fire_block_padded_plain(wt, blk, ops, t_window=t_window,
                                             w_max=7))
    assert (build.FUSED_BLOCK.launches, build.FIRE_BLOCK.launches) == before


# ----------------------------------------------------- batched assignment
@pytest.mark.parametrize("grid", [True, False])
def test_assign_padded_matches_jax(grid):
    w, xs, th, tm, qa, t_window = padded_batch(seed=3, n=23, grid=grid)
    jargs = (jnp.asarray(w), jnp.asarray(xs), jnp.asarray(th), jnp.asarray(tm),
             jnp.asarray(qa))
    targs = (torch.from_numpy(w), torch.from_numpy(xs), th, tm, qa)
    j = np.asarray(jfc.assign_padded(*jargs, t_window=t_window, wta_k=1,
                                     response="rnl", lowering="reference"))
    got = fused_column.assign_padded(*targs, t_window=t_window, response="rnl",
                                     lowering="reference")
    np.testing.assert_array_equal(got.numpy(), j)
    assert got.dtype == torch.int32 and got.shape == (3, 23)
    if grid:  # the kernel lowering fires the integer grid
        ji = np.asarray(jfc.assign_padded(
            *jargs, t_window=t_window, wta_k=1, response="rnl",
            lowering="interpret", w_max=7))
        gk = fused_column.assign_padded(*targs, t_window=t_window,
                                        response="rnl", lowering="cuda", w_max=7)
        np.testing.assert_array_equal(gk.numpy(), ji)
        np.testing.assert_array_equal(gk.numpy(), j)
    with pytest.raises(ValueError, match="w_max"):
        fused_column.assign_padded(*targs, t_window=t_window, response="rnl",
                                   lowering="cuda")
    with pytest.raises(ValueError, match="empty"):
        fused_column.assign_padded(targs[0], targs[1][:0], th, tm, qa,
                                   t_window=t_window, response="rnl")


def test_float_assignment_matches_jax_at_word_synonyms_width():
    """The float-weight assignment at the sweep's real width: WordSynonyms
    (p = 270), q 50 and 25, 300 volleys, weights trained one epoch under
    the paper's STDP from uniform f32 draws (off the grid).  The port sums
    the potential in float64 (exact, so card and CPU agree), JAX's
    reference in float32: ids and firing times must still be equal."""
    x = torch.as_tensor(ucr.load("WordSynonyms").x[:300], dtype=torch.float32)
    cfgs = []
    for q, t_max, scale in ((50, 64, 1.0), (50, 32, 0.75), (25, 64, 1.25)):
        c = ColumnConfig(p=270, q=q, t_max=t_max)
        cfgs.append(c.with_threshold(scale * simulator.suggest_threshold(c)))
    xs = torch.stack([simulator._encode(x, c, "latency") for c in cfgs], 1)
    rng = np.random.default_rng(17)
    w0 = np.zeros((3, 270, 50), np.float32)
    for j, c in enumerate(cfgs):
        w0[j, :, : c.q] = rng.uniform(0, 7, (270, c.q))
    th = [c.neuron.threshold for c in cfgs]
    tm = [c.t_max for c in cfgs]
    qa = [c.q for c in cfgs]
    w = fused_column.fit_scan_padded(
        torch.from_numpy(w0), xs, th, tm, qa, t_window=64, w_max=7, wta_k=1,
        stabilize=True, response="rnl", epochs=1, lowering="reference",
        v_blk=8, **PAPER_MUS)
    assert float((w != torch.round(w)).float().mean()) > 0.5
    got = fused_column.assign_padded(w, xs, th, tm, qa, t_window=64,
                                     response="rnl")
    j = jfc.assign_padded(
        jnp.asarray(w.numpy()), jnp.asarray(xs.numpy()),
        jnp.asarray(np.float32(th)), jnp.asarray(np.int32(tm)),
        jnp.asarray(np.int32(qa)), t_window=64, wta_k=1, response="rnl",
        lowering="reference")
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))
    for d in range(3):
        t = fused_column.fire_dense_ref(w[d], xs[:, d], th[d], 64, tm[d],
                                        acc_dtype=torch.float64)
        jt = jax.vmap(lambda xi: jfc.fire_dense_ref(
            jnp.asarray(w[d].numpy()), xi, th[d], 64, tm[d]))(
                jnp.asarray(xs[:, d].numpy()))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


# ------------------------------- the float-weight fire's slope form
def _slope_twin(w, x, thr, t_max, q_active, t_window, ceil_step=False):
    """A plain twin of ``csrc/fire_float.cu``'s slope form for one design:
    w [p, q] f32, x [N, p] integer times >= 0 -> (times [N, q] f32,
    potentials [N, q, t_end] float64).

    A synapse with w > 0 rises by 1 on cycles x + 1 .. x + n - 1 (n =
    ceil(w): +1 at x, -1 at x + n - 1 in an int difference row) and then
    takes a final step of w - (n - 1) at cycle x + n (a float64 row);
    w <= 0 or NaN is a constant.  ``ceil_step`` takes the ramp a full n
    cycles and then the step w - n, the variant the kernel must not use.
    """
    w = np.asarray(w, np.float32)
    p, q = w.shape
    t_end = min(t_window, math.ceil(t_max))
    base = np.where(w > 0, 0.0, w.astype(np.float64)).sum(0)  # [q]
    times = np.empty((len(x), q), np.float32)
    pots = np.empty((len(x), q, max(t_end, 0)))
    for v, xv in enumerate(np.asarray(x)):
        c = np.zeros((q, t_window + 2), np.int64)
        f = np.zeros((q, t_window + 1))
        for i in range(p):
            xi = int(xv[i])
            if xi >= t_end:
                continue
            for j in np.flatnonzero(w[i] > 0):
                g = w[i, j]
                if g > t_end - xi:  # tops out at or past the window's end
                    c[j, xi] += 1
                    continue
                n1 = math.ceil(g) - 1
                if ceil_step:
                    c[j, xi] += 1
                    c[j, xi + n1 + 1] -= 1
                    f[j, xi + n1] += np.float64(g) - (n1 + 1)
                else:
                    c[j, xi] += 1
                    c[j, xi + n1] -= 1
                    f[j, xi + n1] += np.float64(g) - n1
        slope = np.cumsum(c[:, :t_end], axis=1)
        rises = np.concatenate([np.zeros((q, 1), np.int64),
                                np.cumsum(slope, axis=1)[:, :-1]], axis=1)
        steps = np.concatenate([np.zeros((q, 1)),
                                np.cumsum(f[:, :t_end], axis=1)[:, :-1]], axis=1)
        pot = rises[:, :t_end] + steps[:, :t_end] + base[:, None]
        fired = ~(pot < np.float64(np.float32(thr)))
        t = np.where(fired.any(1), fired.argmax(1), t_end)
        t = np.minimum(t, int(np.float32(t_max))).astype(np.float32)
        times[v] = np.where(np.arange(q) < q_active, t, np.float32(t_max))
        pots[v] = pot
    return times, pots


# every edge of the slope form: tiny weights, the largest f32 below 1,
# integers, zeros, a negative, +inf, NaN
TINY = np.float32(2.0 ** -40 * (1 + 2.0 ** -20))
EDGE_WEIGHTS = np.float32([0.0, 1e-10, 2.0 ** -30, 0.99999994, 1.0, 3.0,
                           7.0, -2.5, np.inf, 0.5, 2.5, TINY])


def _edge_designs(seed=11, p=24, q=8, t_window=24, n=30):
    """Four designs of one envelope: edge weights in every column (NaN in
    one neuron of design 0), half-grid weights whose integer threshold the
    potential reaches exactly, t_max < t_window, q_active < q, and silent
    volleys."""
    rng = np.random.default_rng(seed)
    w = rng.choice(EDGE_WEIGHTS, (4, p, q)).astype(np.float32)
    w[0, 3, 5] = np.nan
    w[2] = rng.integers(0, 15, (p, q)).astype(np.float32) / 2  # ties
    w[3] = rng.uniform(0, 7, (p, q)).astype(np.float32)
    xs = rng.integers(0, t_window + 4, (4, n, p)).astype(np.int32)
    xs[:, :3] = t_window  # silent volleys
    xs[1, 3:6] = 16  # silent at design 1's t_max
    th = np.float32([3.0, 2.5, 6.0, 20.25])
    tm = np.float32([24, 16, 24, 20])
    qa = np.float32([8, 5, 8, 7])
    return w, xs, th, tm, qa, t_window


def test_slope_form_twin_equals_fire_designs_on_edge_weights():
    """The kernel's decomposition (integer rises plus one final step of
    w - (ceil(w) - 1), a constant for w <= 0 or NaN), written plainly here,
    gives ``_fire_designs``' times bit for bit on the edge weights, at
    exact threshold ties, on silent volleys, with t_max < t_window and
    q_active < q."""
    w, xs, th, tm, qa, t_window = _edge_designs()
    ops = fused_column.design_operands(th, tm, qa, 0.0, 0.0, 0.0)
    want = fused_column.fire_float_padded_plain(
        torch.from_numpy(w), torch.from_numpy(xs), ops, t_window=t_window)
    ties = 0
    for d in range(4):
        got, pots = _slope_twin(w[d], xs[d], th[d], tm[d], qa[d], t_window)
        np.testing.assert_array_equal(got, want[d].numpy())
        ties += int((pots == np.float64(th[d])).sum())
    assert ties > 0  # a potential reaches a threshold exactly
    assert (want[0, :, 5] == 0).all()  # the NaN neuron fires at once
    assert (want[1, :, 5:] == 16).all() and (want[1:, :3] == tm[1:, None, None]).all()


def test_the_ceil_step_variant_differs_on_a_tiny_weight():
    """w - ceil(w) rounds in float64 for a tiny w where the plain sum adds
    w exactly: on one live synapse whose threshold is its own weight, the
    twin with the kernel's step fires the cycle after the spike, as
    ``_fire_designs`` does, and the w - ceil(w) variant never fires."""
    w = np.zeros((4, 1), np.float32)
    w[1, 0] = TINY
    x = np.int32([[9, 3, 9, 9]])
    kw = dict(thr=TINY, t_max=8.0, q_active=1, t_window=8)
    want = fused_column.fire_float_padded_plain(
        torch.from_numpy(w[None]), torch.from_numpy(x[None]),
        fused_column.design_operands([TINY], [8], [1], 0.0, 0.0, 0.0),
        t_window=8)
    good, pots = _slope_twin(w, x, **kw)
    bad, bad_pots = _slope_twin(w, x, ceil_step=True, **kw)
    assert float(want[0, 0, 0]) == good[0, 0] == 4.0
    assert bad[0, 0] == 8.0 and bad_pots[0, 0, 4] < pots[0, 0, 4] == TINY
    w[1, 0] = np.float32(1e-10)  # the potential differs at 1e-10 too
    assert _slope_twin(w, x, ceil_step=True, **kw)[1][0, 0, 4] != np.float64(w[1, 0])
    assert _slope_twin(w, x, **kw)[1][0, 0, 4] == np.float64(w[1, 0])


def test_fire_float_wrapper_refuses_bad_operands_before_any_launch():
    """Shapes, dtypes, contiguity and the device are checked before the
    kernel is built or launched; CPU tensors take the plain version."""
    k = build.FIRE_FLOAT
    before = (k.launches, k.builds)
    w = torch.zeros((2, 8, 3), device="meta")
    xs = torch.zeros((2, 5, 8), dtype=torch.int32, device="meta")
    ops = torch.zeros((2, fused_column.N_OPERANDS), device="meta")
    fire = fused_column.fire_float_padded
    with pytest.raises(ValueError, match="one CUDA device"):
        fire(w, xs, ops, t_window=16)
    wc, xc, oc = (torch.zeros(t.shape, dtype=t.dtype) for t in (w, xs, ops))
    with pytest.raises(ValueError, match="one CUDA device"):
        fire(wc, xs, oc, t_window=16)
    with pytest.raises(ValueError, match="float32 tensors"):
        fire(w.double(), xs, ops, t_window=16)
    with pytest.raises(ValueError, match="int32 or float32 times"):
        fire(w, xs.long(), ops, t_window=16)
    with pytest.raises(ValueError, match="contiguous"):
        fire(w, torch.zeros((2, 8, 5), dtype=torch.int32,
                            device="meta").transpose(1, 2), ops, t_window=16)
    with pytest.raises(ValueError, match="needs xs"):
        fire(w, xs.transpose(1, 2), ops, t_window=16)
    with pytest.raises(ValueError, match="operands"):
        fire(w, xs, ops[:, :5], t_window=16)
    with pytest.raises(ValueError, match=r"needs w \[D, p, q\]"):
        fire(w[0], xs, ops, t_window=16)
    assert (k.launches, k.builds) == before
    assert torch.equal(fire(wc, xc, oc, t_window=16),
                       fused_column.fire_float_padded_plain(wc, xc, oc, t_window=16))
    assert (k.launches, k.builds) == before


@pytest.mark.parametrize("response", ["rnl", "snl"])
def test_float_assignment_on_cpu_tensors_runs_fire_designs(monkeypatch, response):
    """On CPU tensors, and for SNL, the reference assignment runs the
    plain ``_fire_designs``, never the float-weight kernel's wrapper."""
    calls = []
    orig = fused_column._fire_designs
    monkeypatch.setattr(fused_column, "_fire_designs",
                        lambda *a: calls.append(a[-1]) or orig(*a))
    monkeypatch.setattr(fused_column, "fire_float_padded", None)
    w, xs, th, tm, qa, t_window = padded_batch(seed=4, n=9, grid=False)
    ids = fused_column.assign_padded(torch.from_numpy(w), torch.from_numpy(xs),
                                     th, tm, qa, t_window=t_window,
                                     response=response)
    assert calls == [response] and ids.shape == (3, 9)


def test_fire_block_plain_matches_jax_fire_and_masks():
    w, xs, th, tm, qa, t_window = padded_batch(seed=5, n=9)
    ops = fused_column.design_operands(th, tm, qa, 0.0, 0.0, 0.0)
    t = fused_column.fire_block_padded_plain(
        torch.from_numpy(w), torch.from_numpy(xs.transpose(1, 0, 2)).float(),
        ops, t_window=t_window, w_max=7)
    for d in range(3):
        for n in range(9):
            j = np.asarray(jfc.fire_dense_ref(
                jnp.asarray(w[d]), jnp.asarray(xs[n, d]), float(th[d]),
                t_window, t_max=int(tm[d])))
            j = np.where(np.arange(5) < qa[d], j, tm[d])
            np.testing.assert_array_equal(t[d, n].numpy(), j.astype(np.float32))
    assert (t <= torch.from_numpy(tm.astype(np.float32))[:, None, None]).all()


def test_ids_from_times_takes_the_first_of_tied_minima():
    rng = np.random.default_rng(0)
    t = rng.integers(0, 4, (3, 50, 6)).astype(np.float32)  # ties everywhere
    tm = np.int32([4, 3, 4])
    t = np.minimum(t, tm[:, None, None].astype(np.float32))
    t[0, :5] = 4.0  # silent volleys
    qa = np.int32([6, 4, 5])
    j = np.asarray(jfc._ids_from_times(jnp.asarray(t), jnp.asarray(tm),
                                       jnp.asarray(qa)))
    got = fused_column._ids_from_times(torch.from_numpy(t), torch.from_numpy(tm),
                                       torch.from_numpy(qa))
    np.testing.assert_array_equal(got.numpy(), j)
    assert (got[0, :5] == 6).all()


def test_pad_stream_silent_and_volley_blocks():
    xs = np.arange(12, dtype=np.int32).reshape(6, 2)
    for n_total in (6, 8):
        out = fused_column.pad_stream_silent(torch.from_numpy(xs), n_total, 99)
        np.testing.assert_array_equal(out.numpy(), jfc.pad_stream_silent(xs, n_total, 99))
    with pytest.raises(ValueError):
        fused_column.pad_stream_silent(torch.from_numpy(xs), 5, 99)
    blocks, n_valid = fused_column._pad_volley_blocks(torch.from_numpy(xs), 4, 99)
    jb, jn = jfc._pad_volley_blocks(jnp.asarray(xs), 4, 99)
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jb))
    assert n_valid == [int(v) for v in np.asarray(jn)]


# ------------------------------------------------------------ the policy
SHAPES = [
    [(20, 5, 24), (20, 2, 12), (20, 3, 20)],
    [(270, 25, 64), (270, 50, 64), (270, 25, 32), (270, 50, 32)] * 3,
    [(65, 2, 64), (637, 2, 64), (470, 5, 64), (270, 25, 64), (96, 2, 32)],
    [(8, 2, 16), (8, 96, 16), (8, 4, 16), (8, 2, 16)],
]


@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: f"{len(s)}shapes")
@pytest.mark.parametrize("waste_cap,max_bucket",
                         [(None, None), (None, 8), (1.0, None), (float("inf"), 3), (2.0, 2)])
def test_envelope_buckets_match_jax(shapes, waste_cap, max_bucket):
    got = backend.envelope_buckets(shapes, waste_cap=waste_cap, max_bucket=max_bucket)
    j = jbackend.envelope_buckets(shapes, waste_cap=waste_cap, max_bucket=max_bucket)
    assert got == j
    assert sorted(i for _, m in got for i in m) == list(range(len(shapes)))


def test_policy_constants_match_jax():
    assert backend.ENVELOPE_WASTE_CAP == jbackend.ENVELOPE_WASTE_CAP
    for low, jlow in (("cuda", "mosaic"), ("reference", "reference")):
        for n in (1, 5, 7, 31, 900):
            for d in (None, 1, 2, 3, 12):
                assert backend.volley_block(low, n, d) == jbackend.volley_block(jlow, n, d)
            for kind in ("fit", "assign"):
                plan = backend.execution_plan(kind, low, 12, n)
                jplan = jcostmodel.constants_plan(kind, jlow, 12, n)
                assert plan.v_blk == jplan.v_blk and plan.waste_cap == jplan.waste_cap
                assert jplan.source == "constants"
                meta = plan.meta()
                jmeta = jplan.meta()
                jmeta.pop("t_blk")  # a TPU tiling knob with no counterpart
                jmeta.update(lowering=low, shards=1)
                assert meta == jmeta
    assert isinstance(backend.execution_plan("fit", "cuda", 2, 9),
                      costmodel.ExecutionPlan)


def test_lowering_ladder_cycle_exact_and_assign_lowering():
    # on the card a kernel failure never steps down to plain PyTorch
    assert backend.lowering_ladder("cuda") == ("cuda",)
    assert backend.lowering_ladder("cuda", cycle_exact=True) == ("cuda",)
    assert backend.lowering_ladder("reference") == ("reference",)
    assert backend.lowering_ladder("reference", cycle_exact=True) == (
        "reference", "cycle")
    assert backend.lowering_ladder("cycle") == ("cycle",)
    with pytest.raises(ValueError, match="unknown lowering"):
        backend.lowering_ladder("mosaic")
    assert backend.MAX_EVAL_RETRIES >= len(
        backend.lowering_ladder("reference", True))
    w_int = np.asarray([[3.0, 0.0], [7.0, 2.0]], np.float32)
    w_float = np.asarray([[3.5, 0.0], [7.0, 2.0]], np.float32)
    grid = ColumnConfig(p=2, q=2, t_max=16, stdp=STDPConfig(
        stabilizer="none", **GRID_MUS))
    jgrid = JColumn(p=2, q=2, t_max=16, stdp=JSTDP(stabilizer="none", **GRID_MUS))
    for cfg, jcfg in ((ColumnConfig(p=2, q=2, t_max=16), JColumn(p=2, q=2, t_max=16)),
                      (grid, jgrid)):
        for w in (w_int, w_float):
            assert backend.cycle_exact(cfg, w) == jbackend.cycle_exact(jcfg, jnp.asarray(w))
    # on the CPU every assignment is the reference fire
    assert backend.assign_lowering("rnl", torch.from_numpy(w_int)) == "reference"


# --------------------------------------------- cluster_time_series_many
def _stream(n=14, length=8, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, length)), rng.integers(0, classes, n)


def _cfgs(grid, length=8):
    """Designs as ``dse.space.candidate_config`` builds them: q x t_max x
    threshold scale times ``suggest_threshold``."""
    stdp = dict(stdp=STDPConfig(stabilizer="none", **GRID_MUS)) if grid else {}
    jstdp = dict(stdp=JSTDP(stabilizer="none", **GRID_MUS)) if grid else {}
    out, jout = [], []
    for q, t_max, scale in ((2, 16, 1.0), (3, 16, 0.75), (3, 24, 1.25), (5, 12, 1.0)):
        c = ColumnConfig(p=length, q=q, t_max=t_max, **stdp)
        jc = JColumn(p=length, q=q, t_max=t_max, **jstdp)
        out.append(c.with_threshold(scale * simulator.suggest_threshold(c)))
        jout.append(jc.with_threshold(scale * jsim.suggest_threshold(jc)))
    return out, jout


def _w_init(cfgs, grid, seed=1):
    rng = np.random.default_rng(seed)
    if grid:
        return [rng.integers(0, 8, (c.p, c.q)).astype(np.float32) for c in cfgs]
    return [rng.uniform(0, 7, (c.p, c.q)).astype(np.float32) for c in cfgs]


@pytest.mark.parametrize("grid", [False, True])
def test_cluster_time_series_many_matches_jax(grid):
    x, y = _stream(n=20, seed=int(grid))
    cfgs, jcfgs = _cfgs(grid)
    w_init = _w_init(cfgs, grid)
    for max_bucket in (None, 2):
        jr = jsim.cluster_time_series_many(x, y, jcfgs, epochs=3, w_init=w_init,
                                           max_bucket=max_bucket)
        tr = simulator.cluster_time_series_many(x, y, cfgs, epochs=3, w_init=w_init,
                                                max_bucket=max_bucket, device="cpu")
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(a.assignments, b.assignments)
            assert a.rand_index == b.rand_index
            np.testing.assert_array_equal(a.params["w"].numpy(), np.asarray(b.params["w"]))
            assert a.lowering == b.lowering == "reference"
            assert (a.buckets, a.shards, a.retries) == (b.buckets, b.shards, b.retries)
            assert a.plan["v_blk"] == b.plan["v_blk"]
            assert a.train_seconds == tr[0].train_seconds > 0
    assert len({len(np.unique(r.assignments)) for r in tr}) >= 1
    assert any(len(np.unique(r.assignments)) > 1 for r in tr)


def test_bucketing_never_changes_results():
    x, y = _stream(n=16, seed=2)
    cfgs, _ = _cfgs(False)
    w_init = _w_init(cfgs, False, seed=4)
    runs = [
        simulator.cluster_time_series_many(x, y, cfgs, epochs=2, w_init=w_init,
                                           device="cpu", **kw)
        for kw in (dict(), dict(waste_cap=float("inf")), dict(max_bucket=1))
    ]
    assert runs[1][0].buckets == 1 and runs[2][0].buckets == len(cfgs)
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a.assignments, b.assignments)
            assert torch.equal(a.params["w"], b.params["w"])


def test_seeded_weights_and_epochs_zero():
    x, y = _stream(n=10, seed=3)
    cfgs, _ = _cfgs(False)
    a = simulator.cluster_time_series_many(x, y, cfgs, epochs=1, seed=5, device="cpu")
    b = simulator.cluster_time_series_many(x, y, cfgs, epochs=1, seed=5, device="cpu")
    for ra, rb in zip(a, b):
        assert torch.equal(ra.params["w"], rb.params["w"])
    w_init = _w_init(cfgs, False)
    z = simulator.cluster_time_series_many(x, y, cfgs, epochs=0, w_init=w_init,
                                           device="cpu")
    for r, w in zip(z, w_init):
        np.testing.assert_array_equal(r.params["w"].numpy(), w)
    assert simulator.cluster_time_series_many(x, y, [], device="cpu") == []
    with pytest.raises(ValueError, match="non-empty"):
        simulator.cluster_time_series_many(x[:0], y[:0], cfgs, device="cpu")
    with pytest.raises(ValueError, match="sharing"):
        simulator.cluster_time_series_many(
            x, y, [cfgs[0], dataclasses.replace(cfgs[1], stdp=STDPConfig(
                stabilizer="none"))], device="cpu")


def test_assign_time_series_matches_jax():
    x, _ = _stream(n=12, seed=6)
    for grid in (False, True):
        cfgs, jcfgs = _cfgs(grid)
        w = _w_init(cfgs, grid, seed=9)[1]
        j = jsim.assign_time_series(x, jcfgs[1], {"w": jnp.asarray(w)})
        got = simulator.assign_time_series(x, cfgs[1], {"w": torch.from_numpy(w)},
                                           device="cpu")
        np.testing.assert_array_equal(got, np.asarray(j))
        one = simulator.assign_time_series(x[3], cfgs[1], {"w": w}, device="cpu")
        assert one == got[3]


# ------------------------------------------------------- fault isolation
def _fail_when(threshold=None, lowerings=None):
    """A ``fit_scan_padded`` that raises when ``threshold`` rides the batch
    (or always, for None) at one of ``lowerings`` (or any)."""
    orig = fused_column.fit_scan_padded

    def wrapper(w, xs, thresholds, *args, **kwargs):
        hit = threshold is None or any(
            float(t) == float(threshold) for t in thresholds)
        if hit and (lowerings is None or kwargs.get("lowering") in lowerings):
            raise RuntimeError("injected fault")
        return orig(w, xs, thresholds, *args, **kwargs)

    return wrapper


def test_kernel_failure_steps_down_to_reference(monkeypatch):
    x, y = _stream(seed=1)
    cfgs, _ = _cfgs(False)
    w_init = _w_init(cfgs, False)
    clean = simulator.cluster_time_series_many(x, y, cfgs, epochs=2,
                                               w_init=w_init, device="cpu")
    # first choice 'cuda', whose kernel wrapper raises: 'cuda' has no rung
    # below it, so nothing steps down to the plain block; every design is
    # re-run alone on 'cuda' and quarantined with its attempts recorded
    monkeypatch.setattr(backend, "padded_lowering", lambda response, t: "cuda")

    def broken(*args, **kwargs):
        raise RuntimeError("injected kernel fault")

    monkeypatch.setattr(fused_column, "fused_block_padded", broken)
    with pytest.raises(RuntimeError, match="injected kernel fault"):
        simulator.cluster_time_series_many(x, y, cfgs, epochs=2, w_init=w_init,
                                           device="cpu")
    res = simulator.cluster_time_series_many(x, y, cfgs, epochs=2, w_init=w_init,
                                             on_error="isolate", device="cpu")
    assert all(isinstance(r, simulator.ClusteringResult) for r in clean)
    for i, a in enumerate(res):
        assert isinstance(a, simulator.EvalFailure), a
        assert a.index == i and a.stage == "fit"
        assert "injected kernel fault" in a.error
        assert a.lowerings == ("cuda", "cuda") and a.retries == 2
        assert "reference" not in a.lowerings and "cycle" not in a.lowerings
    # integer-grid designs, where 'cycle' is exact on the CPU: still no
    # step down from 'cuda'
    gcfgs, _ = _cfgs(True)
    res = simulator.cluster_time_series_many(
        x, y, gcfgs, epochs=2, w_init=_w_init(gcfgs, True),
        on_error="isolate", device="cpu")
    assert all(isinstance(a, simulator.EvalFailure)
               and a.lowerings == ("cuda", "cuda") for a in res)


def test_poisoned_design_quarantined_alone(monkeypatch):
    x, y = _stream(seed=2)
    cfgs, _ = _cfgs(False)
    cfgs = [cfgs[0], cfgs[0].with_threshold(cfgs[0].neuron.threshold * 1.25),
            cfgs[1], cfgs[1].with_threshold(cfgs[1].neuron.threshold * 1.1)]
    w_init = _w_init(cfgs, False, seed=5)
    clean = simulator.cluster_time_series_many(x, y, cfgs, epochs=2,
                                               w_init=w_init, device="cpu")
    monkeypatch.setattr(backend, "padded_lowering", lambda response, t: "cuda")
    monkeypatch.setattr(fused_column, "fit_scan_padded",
                        _fail_when(cfgs[1].neuron.threshold))
    seen = []

    class Monitor:
        def start(self):
            seen.append("start")

        def stop(self):
            seen.append("stop")

    calls = []
    res = simulator.cluster_time_series_many(
        x, y, cfgs, epochs=2, w_init=w_init, on_error="isolate", device="cpu",
        monitor=Monitor(), bucket_callback=lambda idxs, out: calls.append(idxs))
    fail = res[1]
    assert isinstance(fail, simulator.EvalFailure)
    assert fail.index == 1 and fail.stage == "fit"
    assert "injected fault" in fail.error
    assert fail.lowerings == ("cuda", "cuda")  # bucket, then alone
    assert fail.retries == len(fail.lowerings)
    assert "cycle" not in fail.lowerings  # off-grid: the solver is not exact
    assert np.isnan(fail.rand_index)
    for i in (0, 2, 3):
        r = res[i]
        assert isinstance(r, simulator.ClusteringResult), i
        np.testing.assert_array_equal(r.assignments, clean[i].assignments)
        assert torch.equal(r.params["w"], clean[i].params["w"])
        assert r.rand_index == clean[i].rand_index
    assert res[0].lowering == "cuda" and res[0].retries == 1  # re-run alone
    assert seen == ["start", "stop"] * len(calls)
    assert sorted(i for idxs in calls for i in idxs) == [0, 1, 2, 3]


def test_cycle_rung_bit_identical_when_exact(monkeypatch):
    x, y = _stream(seed=3)
    cfgs, _ = _cfgs(True)
    w_init = _w_init(cfgs, True, seed=11)
    clean = simulator.cluster_time_series_many(x, y, cfgs, epochs=2,
                                               w_init=w_init, device="cpu")
    monkeypatch.setattr(fused_column, "fit_scan_padded", _fail_when())
    res = simulator.cluster_time_series_many(x, y, cfgs, epochs=2, w_init=w_init,
                                             on_error="isolate", device="cpu")
    for a, b in zip(res, clean):
        assert isinstance(a, simulator.ClusteringResult)
        assert a.lowering == "cycle" and a.retries == 2 and a.plan is None
        np.testing.assert_array_equal(a.assignments, b.assignments)
        np.testing.assert_array_equal(a.params["w"].numpy(), b.params["w"].numpy())


def test_nan_weights_and_silent_designs_quarantined():
    x, y = _stream(seed=4)
    c = ColumnConfig(p=8, q=2, t_max=16)
    c = c.with_threshold(simulator.suggest_threshold(c))
    cfgs = [c, c, c]
    rng = np.random.default_rng(6)
    w_init = [rng.uniform(0, 7, (8, 2)).astype(np.float32) for _ in range(3)]
    clean = simulator.cluster_time_series_many(
        x, y, cfgs, epochs=1, w_init=[w.copy() for w in w_init], device="cpu")
    w_init[1][3, 1] = np.nan
    res = simulator.cluster_time_series_many(x, y, cfgs, epochs=1, w_init=w_init,
                                             on_error="isolate", device="cpu")
    assert isinstance(res[1], simulator.EvalFailure)
    assert res[1].stage == "weights" and "non-finite" in res[1].error
    for i in (0, 2):
        np.testing.assert_array_equal(res[i].assignments, clean[i].assignments)
    res = simulator.cluster_time_series_many(
        x, y, [c, c.with_threshold(1e9)], epochs=1, on_error="isolate",
        device="cpu")
    assert isinstance(res[0], simulator.ClusteringResult)
    assert isinstance(res[1], simulator.EvalFailure) and res[1].stage == "silent"


def test_on_error_and_w_init_validation(monkeypatch):
    x, y = _stream(seed=5)
    cfgs, _ = _cfgs(False)
    with pytest.raises(ValueError, match="on_error"):
        simulator.cluster_time_series_many(x, y, cfgs, on_error="retry", device="cpu")
    with pytest.raises(ValueError, match="one array per config"):
        simulator.cluster_time_series_many(x, y, cfgs, w_init=[], device="cpu")
    with pytest.raises(ValueError, match="shape"):
        simulator.cluster_time_series_many(
            x, y, cfgs[:1], w_init=[np.zeros((4, 4), np.float32)], device="cpu")
    monkeypatch.setattr(fused_column, "fit_scan_padded",
                        _fail_when(cfgs[0].neuron.threshold))
    with pytest.raises(RuntimeError, match="injected fault"):
        simulator.cluster_time_series_many(x, y, cfgs, epochs=1, device="cpu")


def test_sweep_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfgs, _ = _cfgs(False)
    x, y = _stream()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.cluster_time_series_many(x, y, cfgs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.assign_time_series(x, cfgs[0], {"w": np.zeros((8, 2))})
