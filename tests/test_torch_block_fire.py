"""Port parity, part 8: the slope-histogram form of the volley block's
fire, and the numerics of the bf16 flash kernel.

``csrc/fused_block.cu`` fires through an integer slope histogram: with
integer spike times t_i >= 0 and grid weights g_ij, V_j(t) =
sum_i min(relu(t - t_i), g_ij) is the sum over s < t of the slope c_j(s),
the number of synapses with t_i <= s < t_i + g_ij.  Each live synapse adds
+1 at t_i and -1 at t_i + g_ij to its neuron's difference row (the -1 is
dropped at or past t_end = min(t_window, ceil(t_max))); two prefix sums
give V, and the first t < t_end with V(t) >= threshold is the firing time
(t_end where there is none; t = 0, where V = 0, for a threshold <= 0).
Here a PyTorch copy of that arithmetic is held bit for bit against the JAX
package's ``fire_dense_ref`` and, through a whole volley-block fold, the
port's ``fused_block_padded_plain``.

``csrc/flash_attention.cu`` computes bf16 attention on the tensor cores:
exact bf16 products summed in f32, the scale after the product, and P
split into two bf16 parts for the PV product.  Its emulation on the CPU
must pass the per-element bound that the card check holds the kernel to,
and the same emulation with one bf16 P must fail it: that is why the split
is there.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_column as jfc
from repro_torch.core.types import TIME_DTYPE
from repro_torch.kernels import flash_attention as flash_lib
from repro_torch.kernels import fused_column

W_MAX = 7


# ------------------------------------------------- the slope histogram
def slope_fire(wi, t_in, threshold, t_window, t_max, q_active=None):
    """The kernel's fire for one design: integer grid weights wi [p, q],
    integer times t_in [p] -> firing times [q] int32, clamped to t_max,
    neurons at or past q_active at t_max."""
    p, q = wi.shape
    t_end = min(int(t_window), math.ceil(float(t_max)))
    t_cap = int(float(t_max))
    ti = t_in.to(torch.int64)[:, None].expand(p, q)
    g = wi.to(torch.int64)
    j = torch.arange(q)[None, :].expand(p, q)
    live = (ti >= 0) & (ti < t_end) & (g > 0)
    if q_active is not None:
        live &= j < q_active
    diff = torch.zeros((q, t_window + 1), dtype=torch.int64)
    diff.index_put_((j[live], ti[live]), torch.ones(int(live.sum()), dtype=torch.int64),
                    accumulate=True)
    down = live & (ti + g < t_end)
    diff.index_put_((j[down], (ti + g)[down]),
                    -torch.ones(int(down.sum()), dtype=torch.int64), accumulate=True)
    slope = torch.cumsum(diff[:, :t_end], dim=1)
    # V(0) = 0, then V(s + 1) = sum_{u <= s} c(u)
    v = torch.cat([torch.zeros((q, 1), dtype=torch.int64),
                   torch.cumsum(slope, dim=1)[:, : t_end - 1]], dim=1)
    hit = v.to(torch.float32) >= threshold
    first = torch.where(hit.any(dim=1), hit.to(torch.int64).argmax(dim=1),
                        torch.full((q,), t_end))
    out = torch.minimum(first, torch.tensor(t_cap))
    if q_active is not None:
        out = torch.where(torch.arange(q) < q_active, out, torch.tensor(t_cap))
    return out.to(TIME_DTYPE)


def _edge_inputs(rng, p, q, t_window, t_max):
    """Grid weights with 0 and w_max, and times with every edge: silent at
    t_max and at t_window, t_end - 1, 0."""
    wi = rng.integers(0, W_MAX + 1, (p, q)).astype(np.float32)
    wi[: p // 8] = 0.0
    wi[p // 8 : p // 4] = float(W_MAX)
    t_end = min(t_window, t_max)
    t_in = rng.integers(0, t_window + 8, p).astype(np.int32)
    t_in[0], t_in[1], t_in[2], t_in[3] = t_max, t_window, t_end - 1, 0
    t_in[4 : 4 + p // 10] = t_end - 1
    return wi, t_in


# (p, q, t_window, t_max, threshold scale, q_active)
SLOPE_CASES = [
    (270, 50, 64, 64, 0.25, 50),   # the sweep's envelope (Table II width)
    (270, 50, 64, 40, 0.15, 37),   # t_max < t_window, q_active < q
    (270, 50, 64, 64, 0.0, 50),    # threshold 0 fires at t = 0
    (13, 7, 16, 16, 0.3, 7),       # small
    (13, 7, 16, 9, 0.05, 3),
    (13, 7, 16, 16, 0.0, 5),
    (40, 3, 32, 32, 2.0, 3),       # a threshold no neuron reaches
]


@pytest.mark.parametrize("case", SLOPE_CASES, ids=lambda c: "{}x{}_T{}_tmax{}_thr{}_qa{}".format(*c))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slope_histogram_equals_the_dense_ramp_sum(case, seed):
    p, q, t_window, t_max, scale, q_active = case
    rng = np.random.default_rng(seed * 101 + p + q + t_max)
    wi, t_in = _edge_inputs(rng, p, q, t_window, t_max)
    threshold = float(np.float32(scale * p * 3.5))
    got = slope_fire(torch.from_numpy(wi), torch.from_numpy(t_in), threshold,
                     t_window, t_max, q_active)
    want = np.asarray(jfc.fire_dense_ref(
        jnp.asarray(wi), jnp.asarray(t_in), threshold, t_window, t_max))
    want = np.where(np.arange(q) < q_active, want, t_max)
    np.testing.assert_array_equal(got.numpy(), want)
    port = fused_column.fire_dense_ref(torch.from_numpy(wi), torch.from_numpy(t_in),
                                       threshold, t_window, t_max)
    port = torch.where(torch.arange(q) < q_active, port, t_max)
    assert torch.equal(got, port.to(TIME_DTYPE))


def _slope_fire_dense_ref(w, t_in, threshold, t_window, t_max=None,
                          response="rnl", acc_dtype=torch.float32):
    """``fire_dense_ref``'s signature over [D, p, q] designs, computed by
    ``slope_fire`` design by design (runtime threshold and t_max [D, 1])."""
    assert response == "rnl"
    out = [slope_fire(w[k], t_in[k], float(threshold[k, 0]), t_window,
                      float(t_max[k, 0])) for k in range(w.shape[0])]
    return torch.stack(out)


@pytest.mark.parametrize("p,q,t_window", [(270, 50, 64), (20, 6, 16)])
def test_slope_histogram_through_a_whole_block_fold(monkeypatch, p, q, t_window):
    """32 volleys folded in order with the slope-histogram fire: weights
    equal to the plain version's fold bit for bit."""
    rng = np.random.default_rng(p + q)
    d, v_blk = 3, 32
    w = rng.integers(0, 15, (d, p, q)).astype(np.float32) / 2
    w = torch.from_numpy(np.clip(w + rng.uniform(0, 0.01, w.shape).astype(np.float32)
                                 * (rng.random(w.shape) < 0.3), 0, W_MAX))
    t_in = rng.integers(0, t_window + 8, (d, v_blk, p)).astype(np.float32)
    t_in[:, :, 0] = t_window - 1
    t_in = torch.from_numpy(t_in)
    ops = fused_column.design_operands(
        [0.2 * p * 3.5, 0.0, 0.3 * p * 3.5], [t_window, t_window // 2 + 3, t_window],
        [q, q, max(1, q - 3)], 0.5, 0.5, 1 / 1024)
    kw = dict(t_window=t_window, w_max=W_MAX, wta_k=2, stabilize=True)
    want = fused_column.fused_block_padded_plain(w, t_in, ops, v_blk, **kw)
    monkeypatch.setattr(fused_column, "fire_dense_ref", _slope_fire_dense_ref)
    got = fused_column.fused_block_padded_plain(w, t_in, ops, v_blk, **kw)
    assert torch.equal(got, want)
    assert not torch.equal(got, w)


def test_cuda_lowering_refuses_floating_point_volleys():
    """The kernel's fire is exact for integer spike times only: the 'cuda'
    lowering of the padded scan refuses float volleys (a dtype check, no
    device sync), and takes the same volleys as TIME_DTYPE."""
    rng = np.random.default_rng(5)
    d, p, q, n = 2, 12, 4, 9
    w = torch.from_numpy(rng.integers(0, 8, (d, p, q)).astype(np.float32))
    xs = torch.from_numpy(rng.integers(0, 20, (n, d, p)).astype(np.int32))
    args = dict(t_window=16, w_max=W_MAX, wta_k=1, mu_capture=1.0, mu_backoff=1.0,
                mu_search=1.0, stabilize=False, response="rnl", epochs=1, v_blk=4)
    th, tm, qa = [6.0, 9.0], [16, 12], [4, 3]
    with pytest.raises(ValueError, match="integer volleys"):
        fused_column.fit_scan_padded(w, xs.float(), th, tm, qa, lowering="cuda", **args)
    got = fused_column.fit_scan_padded(w, xs, th, tm, qa, lowering="cuda", **args)
    want = fused_column.fit_scan_padded(w, xs.float(), th, tm, qa,
                                        lowering="reference", **args)
    assert torch.equal(got, want)


# --------------------------------------- the bf16 flash kernel's numerics
def emulate_flash_bf16(q, k, v, causal, split=True, tile=64):
    """The tensor-core kernel's arithmetic on the CPU: bf16 q, k, v; exact
    products summed in f32, times the scale after the product; the running
    max, exp, sum and accumulator in f32 over 64-key tiles; P as
    P_hi + P_lo in bf16 (or one bf16 P); the output rounded to bf16."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().permute(0, 2, 1, 3)  # [B, Hq, Sq, d]
    kf = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    scale = float(np.float32(1.0 / math.sqrt(d)))
    m = torch.full((b, hq, sq, 1), -math.inf)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, skv, tile):
        kt, vt = kf[:, :, k0 : k0 + tile], vf[:, :, k0 : k0 + tile]
        s = (qf.double() @ kt.double().transpose(-1, -2)).float() * scale
        keys = k0 + torch.arange(kt.shape[2])[None, :]
        if causal:
            s = torch.where(keys <= rows, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - m_safe), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        parts = (hi, (p - hi).to(torch.bfloat16).float()) if split else (hi,)
        acc = acc * alpha
        for part in parts:
            acc = acc + (part.double() @ vt.double()).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.to(torch.bfloat16).permute(0, 2, 1, 3)


def test_bf16_flash_needs_the_split_probabilities():
    """At a reduced prefill-like shape (B 1, S 512, Hq 4, Hkv 1, d 128,
    causal), the emulated kernel passes the card check's per-element bound
    against the f32 plain version, |d| <= 2^-8 |ref| + 1e-5 max|ref|, with
    P split into two bf16 parts, and fails it with one bf16 P."""
    rng = np.random.default_rng(512)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
               for s in ((1, 512, 4, 128), (1, 512, 1, 128), (1, 512, 1, 128)))
    ref32 = flash_lib.flash_attention_plain(q.float(), k.float(), v.float(), True)
    bound = 2.0 ** -8 * ref32.abs() + 1e-5 * ref32.abs().max()

    def ratio(out):
        return float(((out.float() - ref32).abs() / bound).max())

    split = ratio(emulate_flash_bf16(q, k, v, True, split=True))
    single = ratio(emulate_flash_bf16(q, k, v, True, split=False))
    assert split <= 1, split
    assert single > 1, single
