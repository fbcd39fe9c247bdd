"""Operation and byte counts against small cases counted by hand."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from nspubench import roofline
from nspubench.reference import tnn


def test_one_volley_counted_by_hand():
    # p 2, q 1: x = (0, 1), w = (2, 1), threshold 2, t_max 4.
    # V(0) = 0, V(1) = 1, V(2) = 2 + 1 = 3: fires at t 2.  Both ramps start
    # inside the window (2 adds) and top out inside it (2 more, at 2 and
    # 2); the scan covers cycles 0..2 (3 cycles, 2 adds each): 10.  STDP
    # on 2 synapses: 20.  Bytes: weights in and out 2 * 2 * 4, the volley
    # 2 * 4, six operands 6 * 4: 48.
    ds = tnn.Designs.of([2.0], [4], [1], [2], "cpu")
    w = torch.tensor([[[2.0], [1.0]]])
    vol = torch.tensor([[[0, 1]]])
    t, st = tnn.fire_grid(w, vol[:, 0], ds, 4, 7)
    assert t.tolist() == [[2]]
    assert (int(st.up[0]), int(st.down[0]), int(st.cycles[0])) == (2, 2, 3)
    _, work, steps = tnn.fold(w.clone(), vol, ds, tnn.Rule(1.0, 1.0, 1.0, False), 1, 4)
    fit = dict(p=2, q=1, n=1, steps=int(steps[0]),
               work=(int(work.up[0]), int(work.down[0]), int(work.cycles[0])))
    assert roofline.load("fused_block").count(fit) == (30, 48)
    assert roofline.load("fused_step").count(fit) == (30, 48)


def test_fire_block_batch_counted_by_hand():
    # a bucket of designs 4x2 and 3x1; requests (4x2: up 5, down 3, 7
    # cycles) and (3x1: 2, 0, 4): 5+3+14 + 2+0+8 = 32 operations; bytes
    # (8 + 3 weights, 6 + 4 volley and times, 12 operands) * 4 = 132
    batch = dict(designs=[(4, 2), (3, 1)], requests=[(4, 2, 5, 3, 7), (3, 1, 2, 0, 4)])
    assert roofline.load("fire_block").count(batch) == (32, 132)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slope_work_equals_its_definition(seed):
    """up, down and cycles equal their definitions counted synapse by
    synapse and cycle by cycle."""
    rng = np.random.default_rng(seed)
    d, p, q, window = 2, 9, 3, 12
    tm, qa = [12, 8], [3, 2]
    g = torch.from_numpy(rng.integers(0, 8, (d, p, q)).astype(np.float32))
    x = torch.from_numpy(rng.integers(0, 14, (d, p)))
    ds = tnn.Designs.of([9.0, 6.5], tm, qa, [p, p], "cpu")
    t, st = tnn.fire_grid(g, x, ds, window, 7)
    for k in range(d):
        up = down = cycles = 0
        for j in range(qa[k]):
            for i in range(p):
                gi, xi = int(g[k, i, j]), int(x[k, i])
                if xi < tm[k] and gi > 0:
                    up += 1
                    down += xi + gi < tm[k]
            v = [sum(min(max(c - int(x[k, i]), 0), int(g[k, i, j]))
                     for i in range(p) if int(x[k, i]) < tm[k]) for c in range(tm[k])]
            fire = next((c for c in range(tm[k]) if v[c] >= float(ds.thr[k])), tm[k])
            assert int(t[k, j]) == fire
            cycles += min(fire + 1, tm[k])
        assert (int(st.up[k]), int(st.down[k]), int(st.cycles[k])) == (up, down, cycles)


def test_roofline_share_reads_nothing_without_its_kernel_or_the_peaks():
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    fit = dict(p=2, q=1, n=1, steps=1, work=(2, 2, 3))
    kernels = {"void fused_block_kernel<true>(...)": [1e-6, 1]}
    assert roofline.share_pct("fused_block", [fit], kernels, None) is None
    assert roofline.share_pct("fused_block", [], kernels, pk) is None
    assert roofline.share_pct("fused_step", [fit], kernels, pk) is None
    want = 100 * max(30 / pk["f32_ops_per_s"], 48 / pk["hbm_bytes_per_s"]) / 1e-6
    assert roofline.share_pct("fused_block", [fit], kernels, pk) == pytest.approx(want)
    assert roofline.peaks("a card nobody listed") is None
