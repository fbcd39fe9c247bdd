"""Port parity, part 10: the per-warp slope-histogram fire of the two
frozen-weight fire kernels, ``csrc/rnl_fire.cu`` and ``csrc/fire_block.cu``.

Each thread block of those kernels stages a tile of volleys and decides,
with one ``__syncthreads_or``, the form it fires them by: int32 times, none
negative, take the slope histogram; float times, or an int32 tile with a
negative time, take the ramp sum.  In the slope form every warp keeps ONE
difference row and fires (volley, neuron) pairs one after another: its
lanes scatter the pair's p synapses into the row (+1 at t_i, -1 at
t_i + g_ij, nothing at or past t_end or for g = 0), then two scans, 32
cycles a step with the carries of the step before, and a ballot find the
first crossing, and the row is left zeroed for the next pair.

Here a numpy copy of that schedule (blocks, tiles, warps, one row per
warp, the 32-lane steps) is held bit for bit against the plain versions,
``rnl_fire_plain`` and ``fire_block_padded_plain``, at the widths the
paths use; the plain versions on int32 times against the JAX package's
kernels as its own tests run them (interpreted); and the routing rule
against the ramp sum on negative and x + 0.5 times.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_column as jfc
from repro.kernels.rnl_response import rnl_fire_pallas
from repro_torch.core.types import TIME_DTYPE
from repro_torch.kernels import fused_column, rnl_response

W_MAX = 7
LANES = 32
# the kernels' constants: (volleys staged a tile, warps a block)
RNL_TILE, RNL_WARPS = 2, 8
FIRE_TILE, FIRE_WARPS = 8, 16


# ----------------------------------------------- the kernels' schedule
def scatter_pair(row, ti, g, t_end):
    """tnn::scatter_ramp of one pair's synapses, lane by lane: +1 at t_i,
    -1 at t_i + g (dropped at or past t_end); nothing for a time at or
    past t_end, a negative time or g = 0."""
    for i in range(ti.shape[0]):
        if 0 <= ti[i] < t_end and g[i] > 0:
            row[int(ti[i])] += 1
            t1 = int(ti[i]) + int(g[i])
            if t1 < t_end:
                row[t1] -= 1


def scan_fire(row, threshold, t_end):
    """tnn::warp_scan_fire_time: 32 cycles a step, lane s holding row[s];
    an inclusive scan plus the carried slope gives c(s), a second scan
    plus the carried potential V(s + 1), and the first lane whose
    V(s + 1) >= threshold (s + 1 < t_end) is the crossing.  Every step
    zeroes its lanes, also after the crossing."""
    thr = np.float32(threshold)
    fire = 0 if np.float32(0.0) >= thr else t_end
    slope = v = 0
    for s0 in range(0, t_end, LANES):
        s = s0 + np.arange(LANES)
        x = np.zeros(LANES, np.int64)
        inside = s < t_end
        x[inside] = row[s[inside]]
        row[s[inside]] = 0
        if fire < t_end:
            continue
        x = np.cumsum(x) + slope
        slope = x[-1]
        x = np.cumsum(x) + v
        v = x[-1]
        hit = (s + 1 < t_end) & (x.astype(np.float32) >= thr)
        if hit.any():
            fire = s0 + int(np.argmax(hit)) + 1
    return fire


def ramp_fire(wi_j, ti, threshold, t_end):
    """tnn::warp_fire_time: the first t < t_end whose f32 ramp sum reaches
    the threshold, else t_end (every partial sum exact)."""
    tif = ti.astype(np.float32)
    for t in range(t_end):
        v = np.minimum(np.maximum(np.float32(t) - tif, 0), wi_j).sum(dtype=np.float32)
        if v >= np.float32(threshold):
            return t
    return t_end


def block_schedule(xs, wi, threshold, t_end, row_len, n_blocks, tile, warps,
                   forms=None):
    """One design's volleys xs [N, p] on grid wi [p, q] as the kernels walk
    them: block b takes volleys [N b / n_blocks, N (b + 1) / n_blocks), a
    tile at a time; the tile's form is the slope histogram where it is
    int32 and none of its times is negative; warp w fires pairs w, w +
    warps, ... of the tile (pair = v q + j) in its own row.  Returns the
    raw firing times [N, q] (before any clamp) and appends each tile's
    form to ``forms``."""
    n, p = xs.shape
    q = wi.shape[1]
    out = np.full((n, q), -1, np.int64)
    for b in range(n_blocks):
        rows = np.zeros((warps, row_len), np.int64)
        lo, hi = n * b // n_blocks, n * (b + 1) // n_blocks
        for v0 in range(lo, hi, tile):
            nv = min(tile, hi - v0)
            slope = xs.dtype == np.int32 and bool((xs[v0 : v0 + nv] >= 0).all())
            if forms is not None:
                forms.append(slope)
            for w in range(warps):
                for pair in range(w, nv * q, warps):
                    v, j = divmod(pair, q)
                    ti = xs[v0 + v]
                    if slope:
                        scatter_pair(rows[w], ti, wi[:, j], t_end)
                        out[v0 + v, j] = scan_fire(rows[w], threshold, t_end)
                        assert not rows[w].any()  # zeroed for the next pair
                    else:
                        out[v0 + v, j] = ramp_fire(wi[:, j], ti, threshold, t_end)
    assert (out >= 0).all()
    return out


def grid_of(w):
    return np.rint(np.clip(w, 0, W_MAX)).astype(np.float32)


def rnl_schedule(t_in, w, threshold, t_max, n_blocks, forms=None):
    """csrc/rnl_fire.cu: t_end = t_max, rows of t_max + 1 ints."""
    return block_schedule(t_in, grid_of(w), threshold, t_max, t_max + 1,
                          n_blocks, RNL_TILE, RNL_WARPS, forms).astype(np.int32)


def fire_block_schedule(w, xs, ops, t_window, n_blocks, forms=None):
    """csrc/fire_block.cu: design by design, t_end = min(t_window,
    ceil(t_max)), rows of t_window + 1 ints, times clamped to int(t_max),
    neurons at or past q_active not fired (t_max)."""
    d, n, _ = xs.shape
    q = w.shape[2]
    out = np.zeros((d, n, q), np.float32)
    for k in range(d):
        thr, tm, qa = (float(v) for v in ops[k, :3])
        t_end = min(t_window, math.ceil(tm))
        t = block_schedule(xs[k], grid_of(w[k]), thr, t_end, t_window + 1,
                           n_blocks, FIRE_TILE, FIRE_WARPS, forms)
        t = np.minimum(t, int(tm))
        t[:, np.arange(q) >= qa] = int(tm)
        out[k] = t
    return out


# ------------------------------------------------------------- inputs
def edge_weights(rng, shape):
    """Weights on the half-integer grid (x.5 is where rounding modes
    disagree) with g = 0 and g = w_max columns."""
    w = rng.integers(0, 2 * W_MAX + 1, shape).astype(np.float32) / 2
    p = shape[-2]
    w[..., : max(1, p // 8), :] = 0.0
    w[..., p // 8 : p // 4, :] = float(W_MAX)
    w[..., 0] = 0.0  # a neuron with g = 0 everywhere
    return w


def edge_times(rng, shape, t_end, t_window):
    """int32 times with every edge: t_end - 1, t_end, t_window and past
    it, and 0."""
    x = rng.integers(0, t_window + 8, shape).astype(np.int32)
    x[..., 0], x[..., 1], x[..., 2], x[..., 3] = t_end - 1, t_end, t_window, 0
    x[..., 4 : 4 + shape[-1] // 10] = t_end - 1
    x[..., -1] = t_window + 5
    return x


def volleys(rng, kind, shape, t_window):
    """int32 times >= 0, f32 x + 0.5 times, int32 times down to -8, or
    (``mixed``) int32 times >= 0 with one negative time in volley 3."""
    if kind == "half":
        return (rng.integers(0, t_window + 8, shape) + 0.5).astype(np.float32)
    if kind == "neg":
        return rng.integers(-8, t_window + 8, shape).astype(np.int32)
    x = rng.integers(0, t_window + 8, shape).astype(np.int32)
    if kind == "mixed":
        x[..., 3, 5] = -3
    return x


# (p, q, volleys): the paths' widths, cut in volleys
SHAPES = [(270, 25, 9), (270, 50, 5), (637, 2, 40), (650, 130, 3)]


@pytest.mark.parametrize("thr_kind", ["scaled", "zero", "above"])
@pytest.mark.parametrize("p,q,b", SHAPES, ids=lambda v: str(v))
def test_rnl_fire_schedule_equals_plain(p, q, b, thr_kind):
    """The RNL-fire kernel's schedule on int32 times with every edge,
    thresholds at 0.25 p 3.5, 0 (fires at 0) and above p * w_max (never
    fires), t_max 64 and 40: bit-equal to ``rnl_fire_plain``."""
    rng = np.random.default_rng(p + q + b)
    w = edge_weights(rng, (p, q))
    thr = {"scaled": 0.25 * p * 3.5, "zero": 0.0, "above": p * W_MAX + 1.0}[thr_kind]
    for t_max in (64, 40):
        t = edge_times(rng, (b, p), t_max, 64)
        want = rnl_response.rnl_fire_plain(torch.from_numpy(t), torch.from_numpy(w),
                                           thr, t_max, W_MAX)
        forms = []
        got = rnl_schedule(t, w, thr, t_max, n_blocks=max(1, b // 3), forms=forms)
        assert all(forms)  # int32, none negative: every tile by the slope form
        np.testing.assert_array_equal(got, want.numpy())
        if thr_kind == "zero":
            assert (got == 0).all()
        if thr_kind == "above":
            assert (got == t_max).all()


@pytest.mark.parametrize("p,q,n", SHAPES, ids=lambda v: str(v))
def test_fire_block_schedule_equals_plain(p, q, n):
    """The batched-fire kernel's schedule, four designs in one launch: t_max
    64, 40 (< t_window) and 33, q_active < q, thresholds 0 and above p *
    w_max beside scaled ones, int32 times with every edge: bit-equal to
    ``fire_block_padded_plain``."""
    rng = np.random.default_rng(p * q + n)
    d, t_window = 4, 64
    w = edge_weights(rng, (d, p, q))
    t_maxes = [64, 40, 33, 64]
    xs = np.stack([edge_times(rng, (n, p), min(t_window, tm), t_window)
                   for tm in t_maxes])
    ops = fused_column.design_operands(
        [0.25 * p * 3.5, 0.0, 0.15 * p * 3.5, p * W_MAX + 1.0], t_maxes,
        [q, max(1, q - 3), 1, q], 0.0, 0.0, 0.0)
    want = fused_column.fire_block_padded_plain(
        torch.from_numpy(w), torch.from_numpy(xs), ops, t_window=t_window,
        w_max=W_MAX)
    forms = []
    got = fire_block_schedule(w, xs, ops.numpy(), t_window, n_blocks=2, forms=forms)
    assert all(forms)
    np.testing.assert_array_equal(got, want.numpy())
    assert (got[1] == np.where(np.arange(q) < max(1, q - 3), 0, 40)).all()
    assert (got[3] == 64).all()


@pytest.mark.parametrize("kind", ["int", "half", "neg", "mixed"])
def test_each_tile_takes_the_slope_form_only_where_it_is_exact(kind):
    """The routing rule: a tile is fired by the slope histogram only where
    its times are int32 and none is negative; f32 x + 0.5 times and int32
    tiles with a negative time take the ramp sum, and every form equals
    the plain versions.  On a negative time the slope form alone would
    be wrong (its ramp would start inside the window at t = 0)."""
    rng = np.random.default_rng(len(kind))
    p, q, n, t_window = 270, 25, 12, 64
    w = edge_weights(rng, (2, p, q))
    xs = volleys(rng, kind, (2, n, p), t_window)
    ops = fused_column.design_operands([0.25 * p * 3.5] * 2, [64, 40], [q, q - 2],
                                       0.0, 0.0, 0.0)
    want = fused_column.fire_block_padded_plain(
        torch.from_numpy(w), torch.from_numpy(xs), ops, t_window=t_window,
        w_max=W_MAX)
    forms = []
    got = fire_block_schedule(w, xs, ops.numpy(), t_window, n_blocks=1, forms=forms)
    np.testing.assert_array_equal(got, want.numpy())
    # tiles of 8 volleys: 0-7 and 8-11 in each design
    expect = {"int": [True] * 4, "half": [False] * 4, "neg": [False] * 4,
              "mixed": [False, True, False, True]}[kind]
    assert forms == expect

    t_b = xs[0]
    forms = []
    want = rnl_response.rnl_fire_plain(torch.from_numpy(t_b), torch.from_numpy(w[0]),
                                       0.25 * p * 3.5, 64, W_MAX)
    got = rnl_schedule(t_b, w[0], 0.25 * p * 3.5, 64, n_blocks=3, forms=forms)
    np.testing.assert_array_equal(got, want.numpy())
    assert all(forms) == (kind == "int") and any(forms) == (kind in ("int", "mixed"))
    if kind == "neg":  # the slope form forced on these times
        g = grid_of(w[0])
        slope_only = np.zeros((n, q), np.int64)
        for v in range(n):
            for j in range(q):
                row = np.zeros(65, np.int64)
                scatter_pair(row, t_b[v], g[:, j], 64)
                slope_only[v, j] = scan_fire(row, 0.25 * p * 3.5, 64)
        assert not np.array_equal(slope_only, want.numpy())


# ----------------------------------- the plain versions against the JAX package
@pytest.mark.parametrize("p,q,b", [(270, 25, 6), (637, 2, 9), (650, 130, 3)],
                         ids=lambda v: str(v))
def test_plain_rnl_fire_on_int32_times_matches_the_interpreted_pallas_kernel(p, q, b):
    rng = np.random.default_rng(b * p)
    w = edge_weights(rng, (p, q))
    t = edge_times(rng, (b, p), 64, 64)
    thr = 0.25 * p * 3.5
    got = rnl_response.rnl_fire(torch.from_numpy(t), torch.from_numpy(w), thr, 64, W_MAX)
    assert got.dtype == TIME_DTYPE
    want = rnl_fire_pallas(jnp.asarray(t), jnp.asarray(w), thr, 64, W_MAX, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the same times as f32 give the same answer
    f32 = rnl_response.rnl_fire(torch.from_numpy(t).float(), torch.from_numpy(w), thr,
                                64, W_MAX)
    assert torch.equal(f32, got)


def test_assign_padded_on_int32_volleys_matches_the_interpreted_pallas_kernel():
    """The sweep's assignment: int32 volleys [N, D, p] through the port's
    ``'cuda'`` lowering (on the CPU, the batched fire's plain version on
    the int32 times as they are) against the JAX package's interpreted
    kernel: equal ids."""
    rng = np.random.default_rng(11)
    d, n, p, q, t_window = 3, 10, 270, 50, 64
    w = edge_weights(rng, (d, p, q))
    t_maxes = np.asarray([64, 40, 33], np.int32)
    xs = edge_times(rng, (n, d, p), 40, t_window)
    th = np.asarray([0.25 * p * 3.5, 0.0, 0.15 * p * 3.5], np.float32)
    qa = np.asarray([q, q - 7, 1], np.int32)
    got = fused_column.assign_padded(
        torch.from_numpy(w), torch.from_numpy(xs), th, t_maxes, qa,
        t_window=t_window, response="rnl", lowering="cuda", w_max=W_MAX)
    want = jfc.assign_padded(
        jnp.asarray(w), jnp.asarray(xs), jnp.asarray(th), jnp.asarray(t_maxes),
        jnp.asarray(qa), t_window=t_window, wta_k=1, response="rnl",
        lowering="interpret", w_max=W_MAX)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f32 = fused_column.assign_padded(
        torch.from_numpy(w), torch.from_numpy(xs.astype(np.float32)), th, t_maxes, qa,
        t_window=t_window, response="rnl", lowering="cuda", w_max=W_MAX)
    assert torch.equal(f32, got)


def test_assign_padded_hands_the_batched_fire_int32_volleys(monkeypatch):
    """The ``'cuda'`` lowering passes int32 volleys to ``fire_block_padded``
    as they are (the kernel's slope form), float volleys as f32."""
    seen = []
    orig = fused_column.fire_block_padded

    def spy(w, xs, ops, **kw):
        seen.append(xs.dtype)
        return orig(w, xs, ops, **kw)

    monkeypatch.setattr(fused_column, "fire_block_padded", spy)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(edge_weights(rng, (2, 40, 6)))
    xs = torch.from_numpy(rng.integers(0, 30, (5, 2, 40)).astype(np.int32))
    kw = dict(t_window=24, response="rnl", lowering="cuda", w_max=W_MAX)
    a = fused_column.assign_padded(w, xs, [9.0, 12.0], [24, 20], [6, 4], **kw)
    b = fused_column.assign_padded(w, xs.double(), [9.0, 12.0], [24, 20], [6, 4], **kw)
    assert seen == [TIME_DTYPE, torch.float32]
    assert torch.equal(a, b)
