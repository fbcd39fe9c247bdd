"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (sm_90) and ``nvcc``; on a host
without CUDA the ``cuda_device`` fixture skips them.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Imports torch and the port only (no JAX), so it runs where JAX is absent.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import backend
from repro_torch.core.types import ColumnConfig, NeuronConfig, STDPConfig
from repro_torch.kernels import build, fused_column, ops, rnl_response, stdp_update

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA (sm_90); see module docstring")
    return torch.device("cuda")


def _half_grid_weights(rng, shape, w_max=7):
    """Weights on the half-integer grid: x.5 values are routine under
    mu = 0.5 and are where rintf and roundf disagree."""
    return rng.integers(0, 2 * w_max + 1, shape).astype(np.float32) / 2


def _fused_case(d, p, q, t_max, seed, hetero):
    rng = np.random.default_rng(seed)
    w = _half_grid_weights(rng, (d, p, q))
    w += rng.uniform(0, 0.01, (d, p, q)).astype(np.float32) * (
        rng.random((d, p, q)) < 0.3)
    w = np.clip(w, 0, 7)  # the weights' range by contract
    t_in = rng.integers(0, t_max + 8, (d, p)).astype(np.float32)
    if hetero:
        thr = rng.uniform(0.1, 0.4, d) * p * 3.5
        t_maxes = rng.integers(t_max // 2, t_max + 1, d)
        q_act = rng.integers(1, q + 1, d)
        mus = (rng.choice([0.5, 1.0, 0.25], d), rng.choice([0.5, 1.0], d),
               rng.choice([1 / 1024, 0.5], d))
    else:
        thr, t_maxes, q_act = [0.25 * p * 3.5] * d, [t_max] * d, [q] * d
        mus = (0.5, 0.5, 1 / 1024)
    ops = fused_column.design_operands(thr, t_maxes, q_act, *mus)
    return torch.from_numpy(w), torch.from_numpy(t_in), ops


FUSED_CASES = [
    # (d, p, q, t_window, wta_k, stabilize, hetero)
    (1, 270, 25, 64, 1, True, False),   # WordSynonyms
    (1, 637, 2, 64, 1, True, False),    # Lightning2
    (4, 270, 25, 64, 2, False, True),
    (4, 96, 5, 64, 1, True, True),
    (3, 65, 40, 64, 2, True, True),     # q wider than a warp
]


@pytest.mark.parametrize("case", FUSED_CASES, ids=lambda c: "d{}_{}x{}_k{}_s{}".format(*c[:3], c[4], int(c[5])))
def test_fused_step_kernel_matches_plain(cuda_device, case):
    d, p, q, t_window, k, stab, hetero = case
    w, t_in, ops = _fused_case(d, p, q, t_window, seed=p + q + d, hetero=hetero)
    kw = dict(t_window=t_window, w_max=7, wta_k=k, stabilize=stab)
    w_ref, y_ref = fused_column.fused_step_padded_plain(w, t_in, ops, **kw)
    before = build.FUSED_STEP.launches
    w_k, y_k = fused_column.fused_step_padded(
        w.to(cuda_device), t_in.to(cuda_device), ops.to(cuda_device), **kw
    )
    torch.cuda.synchronize()
    assert build.FUSED_STEP.launches == before + 1
    assert torch.equal(y_k.cpu(), y_ref)
    assert torch.equal(w_k.cpu(), w_ref), (w_k.cpu() - w_ref).abs().max()


@pytest.mark.parametrize("b,p,q", [(905, 270, 25), (121, 637, 2), (7, 33, 40)])
def test_rnl_fire_kernel_matches_plain(cuda_device, b, p, q):
    rng = np.random.default_rng(b)
    w = torch.from_numpy(_half_grid_weights(rng, (p, q)))
    t_in = torch.from_numpy(rng.integers(0, 72, (b, p)).astype(np.int32))
    thr = 0.25 * p * 3.5
    ref = rnl_response.rnl_fire_plain(t_in, w, thr, 64, 7)
    before = build.RNL_FIRE.launches
    got = rnl_response.rnl_fire(t_in.to(cuda_device), w.to(cuda_device), thr, 64, 7)
    torch.cuda.synchronize()
    assert build.RNL_FIRE.launches == before + 1
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("kind", ["int", "half", "neg"])
def test_fit_fused_on_card_matches_cpu_reference(cuda_device, kind):
    """A whole fit, one launch, bit-equal to the CPU reference lowering:
    int32 volleys (slope form), float volleys with non-integer times and
    int32 volleys with negative times (ramp sum)."""
    cfg = ColumnConfig(p=40, q=6, t_max=32, neuron=NeuronConfig(threshold=30.0))
    rng = np.random.default_rng(3)
    w0 = torch.from_numpy(_half_grid_weights(rng, (40, 6)))
    x = torch.from_numpy(_volleys(rng, kind, (20, 40), 32))
    assert backend.lowering(w0.to(cuda_device)) == "cuda"
    p_ref, y_ref = fused_column.fit_fused({"w": w0}, x, cfg, 3, "reference", True)
    before = build.FUSED_STEP.launches
    p_k, y_k = fused_column.fit_fused(
        {"w": w0.to(cuda_device)}, x.to(cuda_device), cfg, 3, "cuda", True
    )
    torch.cuda.synchronize()
    assert build.FUSED_STEP.launches == before + 1
    assert torch.equal(y_k.cpu(), y_ref)
    assert torch.equal(p_k["w"].cpu(), p_ref["w"])


def _volleys(rng, kind, shape, t_max):
    """int32 times with silent ones (>= t_max), the same shifted by a half
    (f32, non-integer), int32 times down to -8, or (``mixed``) int32
    times down to -8 in the first design only."""
    if kind == "int":
        return rng.integers(0, t_max + 8, shape).astype(np.int32)
    if kind == "half":
        return (rng.integers(0, t_max + 8, shape) + 0.5).astype(np.float32)
    x = rng.integers(-8, t_max + 8, shape).astype(np.int32)
    if kind == "mixed":
        x[1:] = np.abs(x[1:])
    return x


FIT_CASES = [
    # (d, p, q, n, epochs, volleys, trace, wta_k, stabilize, hetero)
    (1, 270, 25, 900, 1, "int", True, 1, True, False),    # WordSynonyms
    (1, 270, 25, 900, 3, "half", False, 1, True, False),
    (1, 270, 25, 7, 3, "int", True, 2, False, False),
    (4, 270, 25, 7, 3, "int", True, 2, True, True),
    (4, 270, 25, 7, 3, "neg", False, 1, True, True),
    (4, 270, 25, 7, 3, "mixed", True, 2, True, True),     # a form per design
    (4, 65, 40, 7, 3, "half", True, 1, True, True),       # q wider than a warp
    (4, 65, 40, 1, 1, "int", True, 2, False, True),
    (1, 637, 2, 7, 3, "int", True, 1, True, False),       # Lightning2
    (1, 637, 50, 7, 3, "neg", True, 2, True, False),      # resident
    (2, 650, 130, 7, 1, "int", True, 1, True, True),      # device memory
    (2, 650, 130, 7, 1, "half", False, 2, False, True),
    (2, 650, 130, 7, 1, "mixed", True, 1, True, True),
    (1, 4000, 8, 7, 3, "int", True, 2, True, False),      # resident
    (1, 4000, 16, 7, 3, "neg", True, 1, True, False),     # device memory
    (1, 4000, 16, 1, 1, "int", False, 1, False, False),
    (4, 96, 5, 7, 0, "int", True, 1, True, True),         # no epoch
]


@pytest.mark.parametrize("case", FIT_CASES, ids=lambda c: "d{}_{}x{}_n{}_e{}_{}_t{}_k{}_s{}".format(
    *c[:6], int(c[6]), c[7], int(c[8])))
def test_fused_fit_kernel_matches_plain(cuda_device, case):
    """The folded kernel, one launch, against the plain fold: weights and
    trace (or the last winner times) bit-equal, in both layouts, across
    epochs, for the three volley kinds."""
    d, p, q, n, epochs, kind, trace, k, stab, hetero = case
    w, _, ops = _fused_case(d, p, q, 64, seed=p + q + n + d, hetero=hetero)
    rng = np.random.default_rng(p * n + epochs)
    xs = torch.from_numpy(_volleys(rng, kind, (d, n, p), 64))
    kw = dict(epochs=epochs, t_window=64, w_max=7, wta_k=k, stabilize=stab, trace=trace)
    w_ref, y_ref = fused_column.fused_fit_padded_plain(w, xs, ops, **kw)
    before = build.FUSED_STEP.launches
    w_k, y_k = fused_column.fused_fit_padded(
        w.to(cuda_device), xs.to(cuda_device), ops.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert build.FUSED_STEP.launches == before + 1
    assert (y_k is None) == (not trace)
    if trace:
        assert y_k.shape == (d, epochs, n, q) and y_k.dtype == torch.int32
        assert torch.equal(y_k.cpu(), y_ref)
    assert torch.equal(w_k.cpu(), w_ref), (w_k.cpu() - w_ref).abs().max()
    if epochs:
        assert not torch.equal(w_k.cpu(), w)


def test_wrappers_refuse_bad_operands(cuda_device):
    w = torch.zeros((1, 8, 2), device=cuda_device)
    t = torch.zeros((1, 8), device=cuda_device)
    ops = fused_column.design_operands([1.0], [8], [2], 0.5, 0.5, 0.5).to(cuda_device)
    kw = dict(t_window=8, w_max=7, wta_k=1, stabilize=True)
    with pytest.raises(ValueError):
        fused_column.fused_step_padded(w.double(), t, ops, **kw)
    with pytest.raises(ValueError):
        fused_column.fused_step_padded(w, t.cpu(), ops, **kw)
    with pytest.raises(ValueError):
        fused_column.fused_fit_padded(w, t[:, None].long(), ops, epochs=1, **kw)
    # 4000 x 16 does not fit in shared memory: the device-memory layout
    assert not build.FUSED_STEP.resident("", 4000, 16, 64)
    wb, tb, ob = _fused_case(1, 4000, 16, 64, seed=4000, hetero=False)
    bkw = dict(kw, t_window=64)
    w_ref, y_ref = fused_column.fused_step_padded_plain(wb, tb, ob, **bkw)
    w_k, y_k = fused_column.fused_step_padded(
        wb.to(cuda_device), tb.to(cuda_device), ob.to(cuda_device), **bkw)
    assert torch.equal(y_k.cpu(), y_ref) and torch.equal(w_k.cpu(), w_ref)
    with pytest.raises(ValueError):
        rnl_response.rnl_fire(t, w[0].double(), 1.0, 8, 7)
    rnl_response.rnl_fire(t, w[0], 1.0, 8, 7)  # the same call, well formed


def _block_case(d, p, q, v_blk, seed, t_window=64):
    """Heterogeneous envelopes (q_active < q, t_max < t_window) with a
    block of volleys; weights on the half-integer grid plus off-grid
    jitter, as training leaves them."""
    rng = np.random.default_rng(seed)
    w = _half_grid_weights(rng, (d, p, q))
    w = np.clip(w + rng.uniform(0, 0.01, w.shape).astype(np.float32)
                * (rng.random(w.shape) < 0.3), 0, 7)
    t_in = rng.integers(0, t_window + 8, (d, v_blk, p)).astype(np.float32)
    thr = rng.uniform(0.1, 0.4, d) * p * 3.5
    t_maxes = rng.integers(t_window // 2, t_window + 1, d)
    q_act = rng.integers(max(1, q // 2), q + 1, d)
    if d > 1:
        q_act[0], t_maxes[-1] = q, t_window
    ops = fused_column.design_operands(
        thr, t_maxes, q_act, rng.choice([0.5, 1.0], d), rng.choice([0.5, 1.0], d),
        rng.choice([1 / 1024, 0.5], d))
    return torch.from_numpy(w), torch.from_numpy(t_in), ops


BLOCK_CASES = [
    # (d, p, q, v_blk, n_valid, wta_k, stabilize)
    (1, 270, 50, 32, 32, 1, True),
    (4, 270, 50, 32, 5, 2, True),    # a tail: n_valid < v_blk
    (4, 270, 25, 7, 7, 1, False),
    (4, 637, 2, 7, 3, 2, False),
    (1, 65, 40, 1, 1, 1, True),      # q wider than a warp
]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: "d{}_{}x{}_v{}_n{}_k{}_s{}".format(*c[:6], int(c[6])))
def test_fused_block_kernel_matches_plain(cuda_device, case):
    d, p, q, v_blk, n_valid, k, stab = case
    w, t_in, ops = _block_case(d, p, q, v_blk, seed=p + q + v_blk + d)
    kw = dict(t_window=64, w_max=7, wta_k=k, stabilize=stab)
    ref = fused_column.fused_block_padded_plain(w, t_in, ops, n_valid, **kw)
    before = build.FUSED_BLOCK.launches
    got = fused_column.fused_block_padded(
        w.to(cuda_device), t_in.to(cuda_device), ops.to(cuda_device), n_valid, **kw)
    torch.cuda.synchronize()
    assert build.FUSED_BLOCK.launches == before + 1
    assert torch.equal(got.cpu(), ref), (got.cpu() - ref).abs().max()


def test_fused_block_kernel_masks_the_tail_of_a_degenerate_design(cuda_device):
    w, t_in, _ = _block_case(2, 40, 6, 4, seed=3, t_window=16)
    t_in[:, 2:] = 16.0  # a silent tail, which threshold 0 would still fire
    ops = fused_column.design_operands([0.0, 0.0], [16, 12], [6, 4], 1.0, 1.0, 1.0)
    kw = dict(t_window=16, w_max=7, wta_k=1, stabilize=False)
    ref = fused_column.fused_block_padded_plain(w, t_in, ops, 2, **kw)
    got = fused_column.fused_block_padded(
        w.to(cuda_device), t_in.to(cuda_device), ops.to(cuda_device), 2, **kw)
    assert torch.equal(got.cpu(), ref)
    assert not torch.equal(
        ref, fused_column.fused_block_padded_plain(w, t_in, ops, 4, **kw))


@pytest.mark.parametrize("n,p,q", [(905, 270, 50), (905, 637, 2), (13, 65, 40)])
def test_fire_block_kernel_matches_plain(cuda_device, n, p, q):
    d = 4
    rng = np.random.default_rng(n + p)
    w = torch.from_numpy(_half_grid_weights(rng, (d, p, q)))
    xs = torch.from_numpy(rng.integers(0, 72, (d, n, p)).astype(np.float32))
    ops = fused_column.design_operands(
        rng.uniform(0.1, 0.4, d) * p * 3.5, [64, 40, 33, 64], [q, max(1, q - 3), 1, q],
        0.0, 0.0, 0.0)
    ref = fused_column.fire_block_padded_plain(w, xs, ops, t_window=64, w_max=7)
    before = build.FIRE_BLOCK.launches
    got = fused_column.fire_block_padded(
        w.to(cuda_device), xs.to(cuda_device), ops.to(cuda_device), t_window=64, w_max=7)
    torch.cuda.synchronize()
    assert build.FIRE_BLOCK.launches == before + 1
    assert torch.equal(got.cpu(), ref)
    tm = ops[:, 1].to(cuda_device)
    qa = ops[:, 2].to(cuda_device)
    assert torch.equal(fused_column._ids_from_times(got, tm, qa).cpu(),
                       fused_column._ids_from_times(ref, ops[:, 1], ops[:, 2]))


def test_padded_fit_and_assign_on_card_match_cpu(cuda_device):
    rng = np.random.default_rng(21)
    d, p, q, n = 3, 30, 6, 41
    w = rng.integers(0, 8, (d, p, q)).astype(np.float32)
    xs = rng.integers(0, 36, (n, d, p)).astype(np.int32)
    th, tm, qa = [12.0, 20.0, 8.0], [32, 24, 20], [6, 4, 3]
    args = dict(t_window=32, w_max=7, wta_k=1, mu_capture=1.0, mu_backoff=1.0,
                mu_search=1.0, stabilize=False, response="rnl", epochs=2)
    cpu = fused_column.fit_scan_padded(torch.from_numpy(w), torch.from_numpy(xs),
                                       th, tm, qa, lowering="reference", v_blk=8,
                                       **args)
    card = fused_column.fit_scan_padded(
        torch.from_numpy(w).to(cuda_device), torch.from_numpy(xs).to(cuda_device),
        th, tm, qa, lowering="cuda", v_blk=32, **args)
    assert torch.equal(card.cpu(), cpu)
    assert backend.assign_lowering("rnl", card) == "cuda"
    kw = dict(t_window=32, response="rnl", w_max=7)
    before = build.FIRE_BLOCK.launches
    ids = fused_column.assign_padded(card, torch.from_numpy(xs).to(cuda_device),
                                     th, tm, qa, lowering="cuda", **kw)
    assert build.FIRE_BLOCK.launches == before + 1
    assert torch.equal(ids.cpu(), fused_column.assign_padded(
        cpu, torch.from_numpy(xs), th, tm, qa, lowering="reference", **kw))


def test_block_wrappers_refuse_bad_operands(cuda_device):
    w = torch.zeros((1, 8, 2), device=cuda_device)
    t = torch.zeros((1, 4, 8), device=cuda_device)
    ops = fused_column.design_operands([1.0], [8], [2], 0.5, 0.5, 0.5).to(cuda_device)
    kw = dict(t_window=8, w_max=7, wta_k=1, stabilize=True)
    with pytest.raises(ValueError):
        fused_column.fused_block_padded(w.double(), t, ops, 4, **kw)
    with pytest.raises(ValueError):
        fused_column.fused_block_padded(w, t.cpu(), ops, 4, **kw)
    with pytest.raises(ValueError):
        fused_column.fused_block_padded(w, t[:, :, :7], ops, 4, **kw)
    # 1200 x 48 does not fit in shared memory: the device-memory layout
    wb, tb, ob = _block_case(1, 1200, 48, 4, seed=600)
    assert not build.FUSED_BLOCK.resident("", 1200, 48, 1, 64)
    bkw = dict(kw, t_window=64)
    ref = fused_column.fused_block_padded_plain(wb, tb, ob, 4, **bkw)
    got = fused_column.fused_block_padded(
        wb.to(cuda_device), tb.to(cuda_device), ob.to(cuda_device), 4, **bkw)
    assert torch.equal(got.cpu(), ref)
    fused_column.fused_block_padded(w, t, ops, 4, **kw)  # well formed
    fkw = dict(t_window=8, w_max=7)
    with pytest.raises(ValueError):
        fused_column.fire_block_padded(w, t.transpose(1, 2), ops, **fkw)
    with pytest.raises(ValueError):
        fused_column.fire_block_padded(w, t.to(torch.int64), ops, **fkw)
    fused_column.fire_block_padded(w, t.to(torch.int32), ops, **fkw)  # int32 times
    # 300 x 200 does not fit in shared memory: the device-memory layout
    wb, tb, ob = _block_case(1, 300, 200, 4, seed=300)
    ref = fused_column.fire_block_padded_plain(wb, tb, ob, t_window=64, w_max=7)
    got = fused_column.fire_block_padded(
        wb.to(cuda_device), tb.to(cuda_device), ob.to(cuda_device),
        t_window=64, w_max=7)
    assert torch.equal(got.cpu(), ref)
    fused_column.fire_block_padded(w, t, ops, **fkw)


def test_fused_block_folds_an_oversized_block_as_sub_launches(cuda_device):
    """A 1000 x 40 envelope at v_blk 32 needs 298,720 B of shared memory;
    the wrapper folds the block's valid volleys as consecutive launches of
    the 15 that fit beside the weights and the fire's histogram, bit-equal
    to the plain version's fold of the whole block."""
    d, p, q, v_blk, n_valid = 4, 1000, 40, 32, 30
    w, t_in, ops_ = _block_case(d, p, q, v_blk, seed=540)
    kw = dict(t_window=64, w_max=7, wta_k=1, stabilize=True)
    per_volley = 4 * p
    # tnn_fused_block_smem_bytes at v_blk 0: weights, winner and firing
    # times, q difference rows of t_window + 1 ints
    fixed = (p * q + q) * 4 + 4 * q + 4 * q * 65
    assert build.FUSED_BLOCK.smem_bytes(p, q, v_blk, 64) == fixed + v_blk * per_volley
    assert build.FUSED_BLOCK.smem_bytes(p, q, v_blk, 64, resident=False) == (
        fixed - 4 * p * q + v_blk * per_volley)
    v_fit = (build.MAX_SMEM_BYTES - fixed) // per_volley
    assert v_fit == 15
    ref = fused_column.fused_block_padded_plain(w, t_in, ops_, n_valid, **kw)
    before = build.FUSED_BLOCK.launches
    got = fused_column.fused_block_padded(
        w.to(cuda_device), t_in.to(cuda_device), ops_.to(cuda_device), n_valid,
        **kw)
    torch.cuda.synchronize()
    assert build.FUSED_BLOCK.launches == before + -(-n_valid // v_fit) == before + 2
    assert torch.equal(got.cpu(), ref), (got.cpu() - ref).abs().max()


@pytest.mark.parametrize("p,q", [(270, 50), (650, 130)], ids=["resident", "device_memory"])
def test_fused_block_kernel_at_the_slope_form_edges(cuda_device, p, q):
    """The slope-histogram fire's edges, in both layouts: grid weights 0
    and w_max, times silent at t_max and at t_window, at t_end - 1 and 0,
    a threshold-0 design, t_max < t_window, q_active < q."""
    d, v_blk, t_window = 4, 32, 64
    rng = np.random.default_rng(p * q + 1)
    w = _half_grid_weights(rng, (d, p, q))
    w[:, : p // 8] = 0.0
    w[:, p // 8 : p // 4] = 7.0
    t_maxes = np.array([64, 40, 64, 33])
    t_in = rng.integers(0, t_window + 8, (d, v_blk, p)).astype(np.float32)
    for k, tm in enumerate(t_maxes):
        t_end = min(t_window, int(tm))
        t_in[k, :, 0], t_in[k, :, 1], t_in[k, :, 2], t_in[k, :, 3] = tm, t_window, t_end - 1, 0
        t_in[k, :, 4 : 4 + p // 10] = t_end - 1
    ops_ = fused_column.design_operands(
        [0.2 * p * 3.5, 0.15 * p * 3.5, 0.0, 0.3 * p * 3.5], t_maxes,
        [q, q - 7, q, 1], [0.5, 1.0, 0.5, 1.0], 0.5, [1 / 1024, 0.5, 0.5, 1 / 1024])
    w, t_in = torch.from_numpy(w), torch.from_numpy(t_in)
    assert build.FUSED_BLOCK.resident("", p, q, 1, t_window) == (p == 270)
    for k, stab in ((1, True), (2, False)):
        kw = dict(t_window=t_window, w_max=7, wta_k=k, stabilize=stab)
        ref = fused_column.fused_block_padded_plain(w, t_in, ops_, 27, **kw)
        got = fused_column.fused_block_padded(
            w.to(cuda_device), t_in.to(cuda_device), ops_.to(cuda_device), 27, **kw)
        assert torch.equal(got.cpu(), ref), (got.cpu() - ref).abs().max()
        assert not torch.equal(ref, w)


def test_fit_scan_padded_refuses_float_volleys_on_the_card(cuda_device):
    """The 'cuda' lowering takes integer volleys only (the kernel's fire is
    exact for integer spike times); the same volleys as TIME_DTYPE run and
    equal the CPU."""
    rng = np.random.default_rng(8)
    d, p, q, n = 2, 30, 6, 20
    w = torch.from_numpy(rng.integers(0, 8, (d, p, q)).astype(np.float32))
    xs = torch.from_numpy(rng.integers(0, 36, (n, d, p)).astype(np.int32))
    args = dict(t_window=32, w_max=7, wta_k=1, mu_capture=1.0, mu_backoff=1.0,
                mu_search=1.0, stabilize=False, response="rnl", epochs=1, v_blk=32)
    th, tm, qa = [12.0, 20.0], [32, 24], [6, 4]
    with pytest.raises(ValueError, match="integer volleys"):
        fused_column.fit_scan_padded(w.to(cuda_device), xs.float().to(cuda_device),
                                     th, tm, qa, lowering="cuda", **args)
    got = fused_column.fit_scan_padded(w.to(cuda_device), xs.to(cuda_device),
                                       th, tm, qa, lowering="cuda", **args)
    want = fused_column.fit_scan_padded(w, xs, th, tm, qa, lowering="reference", **args)
    assert torch.equal(got.cpu(), want)


# ------------------------------------- the device-memory layout
# (p, q): too wide for shared memory in the resident layout for some of
# the four fire kernels: at 650 x 130 for all four, at 4000 x 8 for
# fire_block; at 637 x 50 every kernel stays resident
LAYOUT_SHAPES = [(650, 130), (4000, 8), (637, 50)]


@pytest.mark.parametrize("p,q", LAYOUT_SHAPES)
def test_fire_kernels_in_device_memory_layout_match_plain(cuda_device, p, q):
    """All four fire kernels at widths where some of them cannot keep
    their weights in shared memory: bit-equal to their plain versions, in
    the launches their layouts take."""
    resident = {k.name: k.resident("", p, q, 64) for k in (
        build.FUSED_STEP, build.RNL_FIRE, build.FIRE_BLOCK)}
    resident["fused_block"] = build.FUSED_BLOCK.resident("", p, q, 1, 64)
    assert resident["fused_step"] == ((p, q) != (650, 130))
    assert resident["fused_block"] == ((p, q) != (650, 130))
    assert resident["rnl_fire"] == ((p, q) != (650, 130))
    assert resident["fire_block"] == ((p, q) == (637, 50))

    w, t_in, ops_ = _fused_case(2, p, q, 64, seed=p + q, hetero=True)
    kw = dict(t_window=64, w_max=7, wta_k=2, stabilize=True)
    w_ref, y_ref = fused_column.fused_step_padded_plain(w, t_in, ops_, **kw)
    w_k, y_k = fused_column.fused_step_padded(
        w.to(cuda_device), t_in.to(cuda_device), ops_.to(cuda_device), **kw)
    assert torch.equal(y_k.cpu(), y_ref) and torch.equal(w_k.cpu(), w_ref)

    w, blk, ops_ = _block_case(2, p, q, 32, seed=p * q)
    ref = fused_column.fused_block_padded_plain(w, blk, ops_, 20, **kw)
    before = build.FUSED_BLOCK.launches
    got = fused_column.fused_block_padded(
        w.to(cuda_device), blk.to(cuda_device), ops_.to(cuda_device), 20, **kw)
    torch.cuda.synchronize()
    assert build.FUSED_BLOCK.launches - before == len(
        fused_column.block_sub_launches(p, q, 32, 20, 64))
    assert torch.equal(got.cpu(), ref), (got.cpu() - ref).abs().max()

    ref = fused_column.fire_block_padded_plain(w, blk, ops_, t_window=64, w_max=7)
    got = fused_column.fire_block_padded(
        w.to(cuda_device), blk.to(cuda_device), ops_.to(cuda_device),
        t_window=64, w_max=7)
    assert torch.equal(got.cpu(), ref)

    t_b = blk[0].to(torch.int32)
    thr = 0.25 * p * 3.5
    ref = rnl_response.rnl_fire_plain(t_b, w[0], thr, 64, 7)
    got = rnl_response.rnl_fire(t_b.to(cuda_device), w[0].to(cuda_device), thr, 64, 7)
    assert torch.equal(got.cpu(), ref)


# ------------------------------------- the fire form, block by block
@pytest.mark.parametrize("kind", ["int", "half", "neg", "mixed"])
@pytest.mark.parametrize("p,q", [(270, 50), (650, 130)], ids=["resident", "device_memory"])
def test_fire_kernels_pick_their_form_per_block(cuda_device, p, q, kind):
    """rnl_fire and fire_block on int32 times >= 0 (the slope histogram),
    f32 x + 0.5 times and int32 times with negative ones (the ramp sum),
    and ``mixed`` launches where some blocks take each form, in both
    layouts: bit-equal to the plain versions.  The designs cover t_max <
    t_window, q_active < q, a threshold of 0 and one above p * w_max."""
    d, n = 4, 40
    rng = np.random.default_rng(p + q + len(kind))
    w = torch.from_numpy(np.clip(_half_grid_weights(rng, (d, p, q)), 0, 7))
    xs = torch.from_numpy(_volleys(rng, kind, (d, n, p), 64))
    ops_ = fused_column.design_operands(
        [0.25 * p * 3.5, 0.15 * p * 3.5, 0.0, 7.0 * p + 1], [64, 40, 33, 64],
        [q, q - 3, 1, q], 0.0, 0.0, 0.0)
    assert build.FIRE_BLOCK.resident("", p, q, 64) == (p == 270)
    ref = fused_column.fire_block_padded_plain(w, xs, ops_, t_window=64, w_max=7)
    before = build.FIRE_BLOCK.launches
    got = fused_column.fire_block_padded(
        w.to(cuda_device), xs.to(cuda_device), ops_.to(cuda_device),
        t_window=64, w_max=7)
    torch.cuda.synchronize()
    assert build.FIRE_BLOCK.launches == before + 1
    assert torch.equal(got.cpu(), ref), (got.cpu() - ref).abs().max()

    t_b = xs[0] if kind != "mixed" else xs[1].clone()
    if kind == "mixed":  # one volley's tile takes the ramp sum
        t_b[17, 5] = -3
    for t_max in (64, 40):
        ref = rnl_response.rnl_fire_plain(t_b, w[0], 0.25 * p * 3.5, t_max, 7)
        got = rnl_response.rnl_fire(t_b.to(cuda_device), w[0].to(cuda_device),
                                    0.25 * p * 3.5, t_max, 7)
        assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("p,q,t", [(270, 25, 64), (270, 50, 64), (637, 50, 64),
                                   (650, 130, 32), (4000, 8, 64)])
def test_fire_kernels_smem_bytes_equal_the_mirror(cuda_device, p, q, t):
    """Each source's ``_smem_bytes`` against the formula that
    ``tests/test_torch_flash.py`` mirrors: the grid (resident only), the
    tile of volleys and one difference row of t + 1 ints per warp."""
    for r in (True, False):
        assert build.RNL_FIRE.smem_bytes(p, q, t, resident=r) == (
            (p * q * r + 2 * p) * 4 + 8 * (t + 1) * 4)
        assert build.FIRE_BLOCK.smem_bytes(p, q, t, resident=r) == (
            (p * q * r + 8 * p) * 4 + 16 * (t + 1) * 4)
        assert build.FIRE_FLOAT.smem_bytes(p, q, t, resident=r) == (
            (16 * (t + 1) + q) * 8 + (p * q * r + 8 * p) * 4 + 16 * (t + 1) * 4)


# ------------------------------------- the float-weight fire
def _explore_bucket(encoder, seed=26):
    """One envelope bucket of the exploration cell: the 12 WordSynonyms
    candidates of one encoder (q 25/50 x t_max 32/64 x threshold scale
    0.75/1/1.25) in a p x 50 envelope, t_window 64, N 900, as
    ``simulator._sweep_bucket`` pads them (int32 volleys)."""
    from repro_torch.core import simulator
    from repro_torch.data import ucr

    x = torch.as_tensor(ucr.load("WordSynonyms").x[:900], dtype=torch.float32)
    p = 270 if encoder == "latency" else 540
    cfgs = []
    for q in (25, 50):
        for t_max in (32, 64):
            for scale in (0.75, 1.0, 1.25):
                c = ColumnConfig(p=p, q=q, t_max=t_max)
                cfgs.append(c.with_threshold(scale * simulator.suggest_threshold(c)))
    xs = torch.stack([simulator._encode(x, c, encoder) for c in cfgs], 1)
    rng = np.random.default_rng(seed)
    w0 = np.zeros((12, p, 50), np.float32)
    for j, c in enumerate(cfgs):
        w0[j, :, : c.q] = rng.uniform(0, 7, (p, c.q))
    return (torch.from_numpy(w0), xs.contiguous(),
            [c.neuron.threshold for c in cfgs], [c.t_max for c in cfgs],
            [c.q for c in cfgs])


@pytest.mark.parametrize("encoder", ["latency", "onoff"])
def test_fire_float_kernel_at_the_explore_envelopes(cuda_device, encoder):
    """The exploration cell's two buckets (D 12 at 270 x 50 and 540 x 50,
    T 64, N 900), trained on the card by the cell's float STDP
    (stabiliser, mus 1/2, 1/2, 1/1024, 4 epochs): the kernel's times and
    ids bit-equal to ``_fire_designs`` on the CPU; ``assign_padded``'s
    reference lowering is one fire_float launch and no fire_block."""
    w0, xs, th, tm, qa = _explore_bucket(encoder)
    w = fused_column.fit_scan_padded(
        w0.to(cuda_device), xs.to(cuda_device), th, tm, qa, t_window=64,
        w_max=7, wta_k=1, mu_capture=0.5, mu_backoff=0.5, mu_search=1 / 1024,
        stabilize=True, response="rnl", epochs=4, lowering="cuda", v_blk=32)
    assert backend.assign_lowering("rnl", w) == "reference"
    ops = fused_column.design_operands(th, tm, qa, 0.0, 0.0, 0.0)
    xs_d = xs.transpose(0, 1).contiguous()
    assert xs_d.dtype == torch.int32
    before = build.FIRE_FLOAT.launches
    got = fused_column.fire_float_padded(w, xs_d.to(cuda_device),
                                         ops.to(cuda_device), t_window=64)
    torch.cuda.synchronize()
    assert build.FIRE_FLOAT.launches == before + 1
    assert build.FIRE_FLOAT.resident("", xs.shape[2], 50, 64)
    ref = fused_column.fire_float_padded_plain(w.cpu(), xs_d, ops, t_window=64)
    assert torch.equal(got.cpu(), ref), (got.cpu() != ref).sum()
    ids_ref = fused_column._ids_from_times(ref, ops[:, 1], ops[:, 2])
    launches = (build.FIRE_FLOAT.launches, build.FIRE_BLOCK.launches)
    ids = fused_column.assign_padded(w, xs.to(cuda_device), th, tm, qa,
                                     t_window=64, response="rnl", w_max=7)
    assert (build.FIRE_FLOAT.launches, build.FIRE_BLOCK.launches) == (
        launches[0] + 1, launches[1])
    assert torch.equal(ids.cpu(), ids_ref)
    assert len(torch.unique(ids_ref)) > 25  # the designs cluster, not one id


FLOAT_EDGES = np.float32([0.0, 1e-10, 2.0 ** -30, 0.99999994, 1.0, 3.0, 7.0,
                          -2.5, np.inf, 0.5, 2.5, 2.0 ** -40 * (1 + 2.0 ** -20)])


@pytest.mark.parametrize("kind", ["int", "half", "neg", "mixed"])
@pytest.mark.parametrize("p,q", [(270, 50), (650, 130)], ids=["resident", "device_memory"])
def test_fire_float_kernel_on_edge_weights(cuda_device, p, q, kind):
    """Edge weights (0, 1e-10, 2^-30, 0.99999994, integers, a negative,
    +inf, NaN in one neuron), half-grid weights under integer thresholds
    that the potential reaches exactly, silent volleys, t_max < t_window
    and q_active < q, in both layouts and on the four kinds of times (the
    slope form, and the float64 ramp sum on f32 and negative times): times
    and ids bit-equal to ``_fire_designs`` on the CPU."""
    d, n = 4, 40
    rng = np.random.default_rng(p + q + len(kind))
    w = rng.choice(FLOAT_EDGES, (d, p, q)).astype(np.float32)
    w[0, 7, 3] = np.nan
    w[1] = _half_grid_weights(rng, (p, q))
    w[3] = rng.uniform(0, 7, (p, q)).astype(np.float32)
    xs = _volleys(rng, kind, (d, n, p), 64)
    xs[:, :2] = 64  # silent volleys
    ops = fused_column.design_operands(
        [0.25 * p * 3.5, float(p), 0.0, 0.2 * p * 3.5], [64, 40, 33, 64],
        [q, q - 3, 1, q], 0.0, 0.0, 0.0)
    assert build.FIRE_FLOAT.resident("", p, q, 64) == (p == 270)
    w, xs = torch.from_numpy(w), torch.from_numpy(xs)
    ref = fused_column.fire_float_padded_plain(w, xs, ops, t_window=64)
    before = build.FIRE_FLOAT.launches
    got = fused_column.fire_float_padded(
        w.to(cuda_device), xs.to(cuda_device), ops.to(cuda_device), t_window=64)
    torch.cuda.synchronize()
    assert build.FIRE_FLOAT.launches == before + 1
    assert torch.equal(got.cpu(), ref), (got.cpu() != ref).sum()
    assert torch.equal(fused_column._ids_from_times(got, ops[:, 1].to(cuda_device),
                                                    ops[:, 2].to(cuda_device)).cpu(),
                       fused_column._ids_from_times(ref, ops[:, 1], ops[:, 2]))
    assert (ref[0, :, 3] == 0).all()  # the NaN neuron fires at once
    assert (ref[1, :, q - 3:] == 40).all() and (ref[2, :, 1:] == 33).all()
    assert 0 < float((ref[1] < 40).float().mean()) < 1


def test_fire_float_refuses_bad_operands_on_the_card(cuda_device):
    w = torch.zeros((1, 8, 2), device=cuda_device)
    xs = torch.zeros((1, 4, 8), dtype=torch.int32, device=cuda_device)
    ops = fused_column.design_operands([1.0], [8], [2], 0.0, 0.0, 0.0).to(cuda_device)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_column.fire_float_padded(w, xs.cpu(), ops, t_window=8)
    with pytest.raises(ValueError, match="float32 tensors"):
        fused_column.fire_float_padded(w.double(), xs, ops, t_window=8)
    with pytest.raises(ValueError, match="needs xs"):
        fused_column.fire_float_padded(w, xs[:, :, :7].contiguous(), ops, t_window=8)
    assert fused_column.fire_float_padded(w, xs[:, :0], ops, t_window=8).shape == (1, 0, 2)
    got = fused_column.fire_float_padded(w, xs, ops, t_window=8)
    assert torch.equal(got.cpu(), torch.full((1, 4, 2), 8.0))


STDP_SHAPES = [(13, 3), (270, 25), (650, 130), (7, 1), (540, 50)]


@pytest.mark.parametrize("dtypes", [(torch.int32, torch.int32), (torch.float32, torch.float32),
                                    (torch.int32, torch.float32), (torch.float32, torch.int32)],
                         ids=["int32", "f32", "int32_f32", "f32_int32"])
@pytest.mark.parametrize("stabilize", [True, False], ids=["stab", "plain"])
@pytest.mark.parametrize("p,q", STDP_SHAPES)
def test_stdp_update_kernel_matches_plain(cuda_device, p, q, stabilize, dtypes):
    """x and y each int32 or f32, read by the kernel as they are."""
    rng = np.random.default_rng(p * 7 + q)
    w = rng.uniform(0, 7, (p, q)).astype(np.float32)
    extra = np.array([-0.5, 7.5, 3.5, 0.5, 9.0, 6.5], np.float32)
    w.flat[: min(w.size, extra.size)] = extra[: w.size]
    w = torch.from_numpy(w)
    x = torch.from_numpy(rng.integers(0, 22, p)).to(dtypes[0])
    y = torch.from_numpy(rng.integers(0, 22, q)).to(dtypes[1])
    args = (0.5, 0.5, 1 / 1024, 7, 16, stabilize)
    ref = stdp_update.stdp_update_plain(w, x, y, *args)
    before = build.STDP_UPDATE.launches
    got = stdp_update.stdp_update(w.to(cuda_device), x.to(cuda_device),
                                  y.to(cuda_device), *args)
    torch.cuda.synchronize()
    assert build.STDP_UPDATE.launches == before + 1
    assert torch.equal(got.cpu(), ref), (got.cpu() - ref).abs().max()


def test_stdp_update_refuses_bad_operands(cuda_device):
    w = torch.zeros((8, 2), device=cuda_device)
    x = torch.zeros(8, device=cuda_device)
    y = torch.zeros(2, device=cuda_device)
    args = (0.5, 0.5, 0.5, 7, 16)
    with pytest.raises(ValueError):
        stdp_update.stdp_update(w.double(), x, y, *args)
    with pytest.raises(ValueError):
        stdp_update.stdp_update(w, x.cpu(), y, *args)
    with pytest.raises(ValueError):
        stdp_update.stdp_update(w, x[:7], y, *args)
    with pytest.raises(ValueError):
        stdp_update.stdp_update(w.t(), y, x, *args)
    with pytest.raises(ValueError):  # the kernel reads the times as they lie
        stdp_update.stdp_update(w, torch.zeros((8, 2), device=cuda_device)[:, 0], y, *args)
    with pytest.raises(ValueError):
        stdp_update.stdp_update(w, x.long(), y, *args)
    stdp_update.stdp_update(w, x, y, *args)  # the same call, well formed


def test_ops_entry_points_on_card_match_cpu(cuda_device):
    cfg = ColumnConfig(p=96, q=4, t_max=64, neuron=NeuronConfig(threshold=80.0))
    rng = np.random.default_rng(5)
    w0 = torch.from_numpy(rng.uniform(0, 7, (96, 4)).astype(np.float32))
    x = torch.from_numpy(rng.integers(0, 70, (30, 96)).astype(np.int32))
    fused_cpu = ops.train_volleys({"w": w0}, x, cfg)["w"]
    before = build.FUSED_STEP.launches
    fused = ops.train_volleys({"w": w0.to(cuda_device)}, x.to(cuda_device), cfg)["w"]
    assert build.FUSED_STEP.launches == before + 1  # one launch for all 30 volleys
    w, xd = w0.to(cuda_device), x.to(cuda_device)
    before = (build.RNL_FIRE.launches, build.STDP_UPDATE.launches)
    for i in range(x.shape[0]):
        y = ops.column_forward({"w": w}, xd[i : i + 1], cfg)
        w = ops.stdp_step(w, xd[i], y[0], cfg)
    assert (build.RNL_FIRE.launches, build.STDP_UPDATE.launches) == (
        before[0] + 30, before[1] + 30)
    assert torch.equal(fused.cpu(), fused_cpu)
    assert torch.equal(w.cpu(), fused_cpu)


# --------------------------------------------------- flash attention
def _flash_inputs(b, sq, hq, hkv, d, skv=None, seed=0):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in (
        (b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("b,sq,hq,hkv,d,causal,skv", [
    # the JAX package's test shapes, with grouped KV heads
    (2, 256, 4, 2, 64, True, None),
    (1, 128, 2, 1, 32, False, None),
    (2, 384, 3, 1, 128, True, None),
    (1, 512, 1, 1, 64, True, None),
    # ragged lengths (tails of the 64-row tiles), non-causal, MHA, d 16
    (2, 1000, 8, 2, 128, True, None),
    (1, 1000, 4, 4, 64, False, None),
    (1, 77, 4, 1, 16, False, 130),
    (3, 70, 2, 2, 16, True, None),
])
def test_flash_attention_kernel_matches_plain(cuda_device, b, sq, hq, hkv, d, causal, skv):
    from repro_torch.kernels import flash_attention as flash_lib

    q, k, v = _flash_inputs(b, sq, hq, hkv, d, skv, seed=sq + d)
    ref = flash_lib.flash_attention_plain(q, k, v, causal)  # on the CPU
    before = build.FLASH_ATTENTION.launches
    got = flash_lib.flash_attention(*(t.to(cuda_device) for t in (q, k, v)), causal)
    torch.cuda.synchronize()
    assert build.FLASH_ATTENTION.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got.cpu(), ref) < 2e-5
    # bf16 in and out, the JAX package's bf16 tolerance
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    ref = flash_lib.flash_attention_plain(qb, kb, vb, causal)
    got = flash_lib.flash_attention(*(t.to(cuda_device) for t in (qb, kb, vb)), causal)
    assert got.dtype == torch.bfloat16
    assert _rel(got.cpu(), ref) < 2e-2
    # per element, against the plain version in f32 on the same bf16 values:
    # one rounding to bf16 plus 1e-5 of the largest output
    ref32 = flash_lib.flash_attention_plain(qb.float(), kb.float(), vb.float(), causal)
    bound = 2.0 ** -8 * ref32.abs() + 1e-5 * ref32.abs().max()
    assert bool(((got.cpu().float() - ref32).abs() <= bound).all())


# (Sq, Skv): 64-key and 128-row tile edges, Skv != Sq both ways
RAGGED = [(1, 1), (63, 63), (65, 65), (129, 129), (1000, 1000), (65, 129),
          (129, 63), (1, 1000)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_bf16_tensor_core_kernel_at_ragged_edges(cuda_device, d, group, causal):
    """The bf16 kernel (wgmma, TMA) at every head dim, GQA group and tile
    edge: per element against the f32 plain version on the same bf16
    values within one bf16 rounding plus 1e-5 of the largest output, and
    within 2e-2 of the largest against the bf16 plain version."""
    from repro_torch.kernels import flash_attention as flash_lib

    for sq, skv in RAGGED:
        q, k, v = (t.to(torch.bfloat16) for t in _flash_inputs(
            2, sq, 2 * group, 2, d, skv, seed=sq + skv + d + group))
        before = build.FLASH_ATTENTION.launches
        got = flash_lib.flash_attention(*(t.to(cuda_device) for t in (q, k, v)), causal)
        torch.cuda.synchronize()
        assert build.FLASH_ATTENTION.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        got = got.cpu().float()
        ref32 = flash_lib.flash_attention_plain(q.float(), k.float(), v.float(), causal)
        bound = 2.0 ** -8 * ref32.abs() + 1e-5 * ref32.abs().max()
        assert bool(((got - ref32).abs() <= bound).all()), (sq, skv)
        assert _rel(got, flash_lib.flash_attention_plain(q, k, v, causal)) < 2e-2


@pytest.mark.parametrize("b,sq,hq,hkv,causal,skv", [
    (1, 300, 64, 8, True, None),    # kimi-k2's GQA 64:8
    (1, 300, 64, 8, False, None),
    (2, 200, 32, 32, True, None),   # zamba2's MHA
    (2, 200, 32, 32, False, None),
    (2, 1, 16, 16, False, 1500),    # one decode row over 1500 keys
    (1, 77, 8, 1, False, 130),      # Sq, Skv not multiples of the tiles
    (1, 129, 8, 2, True, None),
])
def test_flash_head_dim_112_matches_plain(cuda_device, b, sq, hq, hkv, causal, skv):
    """Head dim 112 through the kernel (bf16: the D = 128 tiles on tensor
    maps of inner extent 112; f32: the CUDA-core kernel at D = 112), with
    no padded copy: f32 within 2e-5 of the plain version; bf16 per element
    against the plain version in f32 on the same bf16 values, within one
    bf16 rounding plus 1e-5 of the largest output."""
    from repro_torch.kernels import flash_attention as flash_lib

    q, k, v = _flash_inputs(b, sq, hq, hkv, 112, skv, seed=sq + hq)
    ref = flash_lib.flash_attention_plain(q, k, v, causal)
    before = build.FLASH_ATTENTION.launches
    got = flash_lib.flash_attention(*(t.to(cuda_device) for t in (q, k, v)), causal)
    torch.cuda.synchronize()
    assert build.FLASH_ATTENTION.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got.cpu(), ref) < 2e-5
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = flash_lib.flash_attention(*(t.to(cuda_device) for t in (qb, kb, vb)), causal)
    torch.cuda.synchronize()
    assert build.FLASH_ATTENTION.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == qb.shape
    got = got.cpu().float()
    ref32 = flash_lib.flash_attention_plain(qb.float(), kb.float(), vb.float(), causal)
    bound = 2.0 ** -8 * ref32.abs() + 1e-5 * ref32.abs().max()
    assert bool(((got - ref32).abs() <= bound).all())
    assert _rel(got, flash_lib.flash_attention_plain(qb, kb, vb, causal)) < 2e-2


@pytest.mark.parametrize("b,sq,hq,hkv,causal,skv", [
    (2, 200, 32, 32, True, None),   # zamba2-7b-instruct's MHA
    (2, 200, 32, 32, False, None),
    (1, 300, 4, 1, True, None),     # grouped, causal edges
    (2, 1, 16, 16, False, 1500),    # one decode row over 1500 keys
    (1, 77, 8, 1, False, 130),      # Sq, Skv not multiples of the tiles
    (1, 129, 8, 2, True, None),
])
def test_flash_head_dim_224_matches_plain(cuda_device, b, sq, hq, hkv, causal, skv):
    """Head dim 224 through the kernel (bf16: the D = 256 tiles on tensor
    maps of inner extent 224, two K/V stages; f32: the CUDA-core kernel at
    D = 224), with Zamba2's scale (224 / 2)^-1/2: f32 within 2e-5 of the
    plain version; bf16 per element against the plain version in f32 on
    the same bf16 values, within one bf16 rounding plus 1e-5 of the
    largest output."""
    from repro_torch.kernels import flash_attention as flash_lib

    scale = 112 ** -0.5
    q, k, v = _flash_inputs(b, sq, hq, hkv, 224, skv, seed=sq + hq + 224)
    ref = flash_lib.flash_attention_plain(q, k, v, causal, scale=scale)
    before = build.FLASH_ATTENTION.launches
    got = flash_lib.flash_attention(*(t.to(cuda_device) for t in (q, k, v)), causal,
                                    scale=scale)
    torch.cuda.synchronize()
    assert build.FLASH_ATTENTION.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got.cpu(), ref) < 2e-5
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = flash_lib.flash_attention(*(t.to(cuda_device) for t in (qb, kb, vb)), causal,
                                    scale=scale)
    torch.cuda.synchronize()
    assert build.FLASH_ATTENTION.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == qb.shape
    got = got.cpu().float()
    ref32 = flash_lib.flash_attention_plain(qb.float(), kb.float(), vb.float(), causal,
                                            scale=scale)
    bound = 2.0 ** -8 * ref32.abs() + 1e-5 * ref32.abs().max()
    assert bool(((got - ref32).abs() <= bound).all())
    assert _rel(got, flash_lib.flash_attention_plain(qb, kb, vb, causal, scale=scale)) < 2e-2


def _mla_inputs(b, sq, h, skv=None, seed=0):
    """q and k at 192, v at 128 (MLA's expanded prefill): k's last 64
    columns one rope head shared by every head, as the model builds it."""
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    q = torch.from_numpy(rng.normal(size=(b, sq, h, 192)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, skv, h, 192)).astype(np.float32))
    k[..., 128:] = torch.from_numpy(rng.normal(size=(b, skv, 1, 64)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, skv, h, 128)).astype(np.float32))
    return q, k, v


@pytest.mark.parametrize("b,sq,h,causal,skv", [
    (2, 200, 32, True, None),     # DeepSeek-V3's 32 heads
    (2, 200, 32, False, None),
    (1, 300, 4, True, None),      # causal edges
    (2, 1, 16, False, 1500),      # one query row over 1500 keys
    (1, 77, 8, False, 130),       # Sq, Skv not multiples of the tiles
    (1, 129, 8, True, None),
    (1, 1000, 2, True, None),
])
def test_flash_mla_head_dims_match_plain(cuda_device, b, sq, h, causal, skv):
    """Q and K at 192, V and O at 128 through the kernel (bf16: the
    ``flash_mla_kernel<192, 128>`` instantiation, Q and K in three 64-column
    boxes, V in two, no padded copy of V; f32: the CUDA-core kernel at 192 /
    128), scores scaled by 192^-1/2: f32 within 2e-5 of the plain version;
    bf16 per element against the plain version in f32 on the same bf16
    values, within one bf16 rounding plus 1e-5 of the largest output, the
    bound the other head dims are held to."""
    from repro_torch.kernels import flash_attention as flash_lib

    q, k, v = _mla_inputs(b, sq, h, skv, seed=sq + h)
    ref = flash_lib.flash_attention_plain(q, k, v, causal)
    before = build.FLASH_ATTENTION.launches
    got = flash_lib.flash_attention(*(t.to(cuda_device) for t in (q, k, v)), causal)
    torch.cuda.synchronize()
    assert build.FLASH_ATTENTION.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == ref.shape == (b, sq, h, 128)
    assert _rel(got.cpu(), ref) < 2e-5
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = flash_lib.flash_attention(*(t.to(cuda_device) for t in (qb, kb, vb)), causal)
    torch.cuda.synchronize()
    assert build.FLASH_ATTENTION.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    got = got.cpu().float()
    ref32 = flash_lib.flash_attention_plain(qb.float(), kb.float(), vb.float(), causal)
    bound = 2.0 ** -8 * ref32.abs() + 1e-5 * ref32.abs().max()
    assert bool(((got - ref32).abs() <= bound).all())
    assert _rel(got, flash_lib.flash_attention_plain(qb, kb, vb, causal)) < 2e-2


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_mla_head_dims_at_ragged_edges(cuda_device, causal):
    """The 192 / 128 instantiation at every 64-key and 128-row tile edge,
    Skv != Sq both ways, in bf16: per element against the f32 plain
    version on the same bf16 values."""
    from repro_torch.kernels import flash_attention as flash_lib

    for sq, skv in RAGGED:
        q, k, v = (t.to(torch.bfloat16) for t in _mla_inputs(2, sq, 4, skv, seed=sq + skv))
        got = flash_lib.flash_attention(*(t.to(cuda_device) for t in (q, k, v)), causal)
        torch.cuda.synchronize()
        assert got.shape == (2, sq, 4, 128)
        got = got.cpu().float()
        ref32 = flash_lib.flash_attention_plain(q.float(), k.float(), v.float(), causal)
        bound = 2.0 ** -8 * ref32.abs() + 1e-5 * ref32.abs().max()
        assert bool(((got - ref32).abs() <= bound).all()), (sq, skv)


def test_flash_refuses_unequal_head_dims_it_has_no_build_of(cuda_device):
    from repro_torch.kernels import flash_attention as flash_lib

    q, k, v = (t.to(torch.bfloat16).to(cuda_device) for t in _mla_inputs(1, 64, 2))
    with pytest.raises(ValueError):
        flash_lib.flash_attention(q[..., :128].contiguous(), k[..., :128].contiguous(),
                                  v[..., :64].contiguous())
    with pytest.raises(ValueError):
        flash_lib.flash_attention(q, k, v[..., :112].contiguous())
    flash_lib.flash_attention(q, k, v)  # well formed


@pytest.mark.parametrize("d", [64, 112, 224])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_reads_the_leading_rows_of_a_cache(cuda_device, d, dtype):
    """K and V as the leading n rows of a [B, R, H, d] cache (a decode
    step's attention over the filled positions): the kernel reads them
    where they lie, the rows past n (large finite garbage here: the bf16
    kernel's last tile multiplies them by a probability of 0) masked, the
    same result as on contiguous copies; one query row and a prefill's
    worth of rows alike."""
    from repro_torch.kernels import flash_attention as flash_lib

    b, R, h = 3, 700, 4
    _, ck, cv = (t.to(dtype) for t in _flash_inputs(b, 1, h, h, d, R, seed=d))
    ck[:, 600:] = 1e4
    cv[:, 600:] = -3e4
    for sq, n, causal in ((1, 517, False), (1, 64, False), (40, 600, False), (600, 600, True)):
        q = _flash_inputs(b, sq, h, h, d, seed=n)[0].to(dtype)
        k, v = ck[:, :n], cv[:, :n]
        assert not k.is_contiguous()
        want = flash_lib.flash_attention(*(t.contiguous().to(cuda_device) for t in (q, k, v)),
                                         causal)
        got = flash_lib.flash_attention(q.to(cuda_device), ck.to(cuda_device)[:, :n],
                                        cv.to(cuda_device)[:, :n], causal)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want.cpu()), (sq, n)


@pytest.mark.parametrize("d", [64, 224])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_reads_its_key_count_from_the_device(cuda_device, d, dtype):
    """``kv_len`` (one int32 on the card) in place of the host's count: the
    same result as the cache's leading rows, for lengths across the 64-key
    tiles, with the rows past the length holding garbage."""
    from repro_torch.kernels import flash_attention as flash_lib

    b, R, h = 2, 300, 4
    _, ck, cv = (t.to(dtype).to(cuda_device) for t in _flash_inputs(b, 1, h, h, d, R, seed=d))
    ck[:, 200:] = 3e4
    cv[:, 200:] = -3e4
    q = _flash_inputs(b, 1, h, h, d, seed=1)[0].to(dtype).to(cuda_device)
    for n in (1, 63, 64, 65, 200):
        want = flash_lib.flash_attention(q, ck[:, :n], cv[:, :n], False)
        got = flash_lib.flash_attention(q, ck, cv, False, kv_len=torch.tensor(
            [n], dtype=torch.int32, device=cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(got, want), n


def test_zamba2_decode_graph_equals_the_eager_decode(cuda_device):
    """The published Zamba2's decode step as a CUDA graph (``DecodeGraph``,
    what ``launch.serve`` runs on the card) against the eager decode step
    on the same card, smoke config in f32: the same logits bit for bit,
    step after step, and the same greedy tokens through ``serve`` twice
    (the second batch on the kept graph, its cache reset); the model keeps
    one graph, and a batch of another shape replaces it."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import transformer as T
    from repro_torch.models import zamba2

    cfg = get_arch("zamba2-7b-instruct", smoke=True)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    with torch.inference_mode():
        model = T.init_params(cfg, generator=gen, device=cuda_device)
        with torch.no_grad():
            for a in model.apps:
                a.adapter_b.normal_(0, 0.1, generator=gen)
        tok = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, device=cuda_device)
        graph = zamba2.decode_graph(model, 2, 48)
        assert zamba2.decode_graph(model, 2, 48) is graph  # kept for the shape
        cache, _ = T.prefill(model, tok[:, :33], max_len=48, cache=graph.cache)
        eager, _ = T.prefill(model, tok[:, :33], max_len=48)
        for t in range(33, 40):
            got = graph.step(tok[:, t: t + 1], t).clone()
            eager, want = T.decode_step(model, eager, tok[:, t: t + 1])
            torch.cuda.synchronize()
            assert torch.equal(got, want), t
        r = serve_lib.serve(cfg, tokens=6, device=cuda_device, model=model, prompts=tok,
                            keep=[0])
        r2 = serve_lib.serve(cfg, tokens=6, device=cuda_device, model=model, prompts=tok)
        cache, lg = T.prefill(model, tok, max_len=47)
        toks = [lg[:, -1:, : cfg.vocab_size].argmax(-1)]
        for _ in range(5):
            cache, lg = T.decode_step(model, cache, toks[-1])
            toks.append(lg[:, -1:, : cfg.vocab_size].argmax(-1))
    assert np.array_equal(r.generations, torch.cat(toks, 1).cpu().numpy())
    assert np.array_equal(r2.generations, r.generations)
    kept = model.__dict__["_decode_graph"][1]
    with torch.inference_mode():
        other = zamba2.decode_graph(model, 1, 48)
    assert other is not kept and model.__dict__["_decode_graph"][1] is other


def test_granite4h_decode_graph_equals_the_eager_decode(cuda_device):
    """Granite 4.0-H's decode step as a CUDA graph (``zamba2.DecodeGraph``
    over its cache, what ``launch.serve`` runs on the card; its MoE on the
    static dropless path) against the eager decode step on the same card,
    smoke config in f32: the same logits and routing bit for bit, step
    after step; ``serve`` gives the eager greedy tokens, and the prefill's
    logits match the CPU's."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import granite4h
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("granite-4.0-h-small", smoke=True)
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    model = T.Transformer(T.weights(cpu, lambda t: t.detach().to(cuda_device)), cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        graph = granite4h.decode_graph(model, 2, 48)
        _, l_card = T.prefill(model, tok[:, :33].to(cuda_device), max_len=48,
                              cache=graph.cache)
        _, l_cpu = T.prefill(cpu, tok[:, :33], max_len=48)
        assert _rel(l_card.cpu(), l_cpu) < 1e-4
        eager, _ = T.prefill(model, tok[:, :33].to(cuda_device), max_len=48)
        for t in range(33, 40):
            x = tok[:, t: t + 1].to(cuda_device)
            got = graph.step(x, t).clone()
            route = graph.cache["route"].clone()
            eager, want = T.decode_step(model, eager, x)
            torch.cuda.synchronize()
            assert torch.equal(got, want), t
            assert torch.equal(route, eager["route"]), t
        prompts = tok.to(cuda_device)
        r = serve_lib.serve(cfg, tokens=6, device=cuda_device, model=model, prompts=prompts,
                            keep=[1])
        cache, lg = T.prefill(model, prompts, max_len=47)
        toks = [lg[:, -1:, : cfg.vocab_size].argmax(-1)]
        for _ in range(5):
            cache, lg = T.decode_step(model, cache, toks[-1])
            toks.append(lg[:, -1:, : cfg.vocab_size].argmax(-1))
    assert np.array_equal(r.generations, torch.cat(toks, 1).cpu().numpy())
    assert r.kept_taps["moe"].shape == (1, cfg.n_layers, 40, cfg.d_model)


def test_deepseek_v3_decode_graph_equals_the_eager_decode(cuda_device):
    """DeepSeek-V3's decode step as a CUDA graph (``zamba2.DecodeGraph``
    over its latent cache, what ``launch.serve`` runs on the card: the
    absorbed MLA over the cache's rows up to the device position, the
    static MoE) against the eager decode step on the same card, smoke
    config in f32: the same logits and routing bit for bit, step after
    step; the prefill (a row at a time, the 192 / 128 flash kernel in f32)
    matches the CPU's; ``serve`` gives the eager greedy tokens, with and
    without ``prefill_at``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import deepseek_v3
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("kanana-2-30b-a3b-instruct", smoke=True)
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    model = T.Transformer(T.weights(cpu, lambda t: t.detach().to(cuda_device)), cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        graph = deepseek_v3.decode_graph(model, 2, 48)
        before = build.FLASH_ATTENTION.launches
        _, l_card = T.prefill(model, tok[:, :33].to(cuda_device), max_len=48,
                              cache=graph.cache)
        assert build.FLASH_ATTENTION.launches == before + 2 * cfg.n_layers
        _, l_cpu = T.prefill(cpu, tok[:, :33], max_len=48)
        assert _rel(l_card.cpu(), l_cpu) < 1e-4
        eager, _ = T.prefill(model, tok[:, :33].to(cuda_device), max_len=48)
        for t in range(33, 40):
            x = tok[:, t: t + 1].to(cuda_device)
            got = graph.step(x, t).clone()
            route = graph.cache["route"].clone()
            eager, want = T.decode_step(model, eager, x)
            torch.cuda.synchronize()
            assert torch.equal(got, want), t
            assert torch.equal(route, eager["route"]), t
        prompts = tok.to(cuda_device)
        r = serve_lib.serve(cfg, tokens=6, device=cuda_device, model=model, prompts=prompts,
                            keep=[1])
        r2 = serve_lib.serve(cfg, tokens=6, device=cuda_device, model=model, prompts=prompts,
                             keep=[1], prefill_at=[5, 39])
        cache, lg = T.prefill(model, prompts, max_len=47)
        toks = [lg[:, -1:, : cfg.vocab_size].argmax(-1)]
        for _ in range(5):
            cache, lg = T.decode_step(model, cache, toks[-1])
            toks.append(lg[:, -1:, : cfg.vocab_size].argmax(-1))
    assert np.array_equal(r.generations, torch.cat(toks, 1).cpu().numpy())
    assert np.array_equal(r2.generations, r.generations)
    assert _rel(r2.prefill_logits.cpu(), r.prefill_logits[:, [5, 39]].cpu()) < 1e-5
    # the kept row's chosen experts at every prompt position and decode step
    assert r.kept_taps["route"].shape == (1, cfg.n_moe, 40, cfg.top_k)
    assert r.kept_taps["route_decode"].shape == (1, cfg.n_moe, 5, cfg.top_k)
    assert r2.kept_cache["latent"].shape == (cfg.n_layers, 1, 2 + 5, cfg.latent_dim)


def test_flash_attention_refuses_bad_operands(cuda_device):
    from repro_torch.kernels import flash_attention as flash_lib

    q, k, v = (t.to(cuda_device) for t in _flash_inputs(1, 64, 4, 2, 64))
    with pytest.raises(ValueError):
        flash_lib.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_lib.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):  # Hkv must divide Hq
        flash_lib.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError):  # a head dim the kernel has no build of
        flash_lib.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                  v[..., :48].contiguous())
    with pytest.raises(ValueError):
        flash_lib.flash_attention(q.transpose(1, 2), k, v)
    flash_lib.flash_attention(q, k, v)  # well formed


def test_smoke_lm_on_card_matches_cpu(cuda_device):
    """The granite smoke model (f32, d_head 16): card logits (flash
    kernel) against CPU logits (plain version) from the same weights,
    prefill then two decode steps; one flash launch per layer per
    prefill."""
    from repro_torch import configs
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_arch("granite-3-8b", smoke=True)
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = T.params_from_jax(T.params_to_numpy(cpu), cfg, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 21), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        c_cpu, l_cpu = T.prefill(cpu, toks[:, :19], max_len=24)
        before = build.FLASH_ATTENTION.launches
        c_card, l_card = T.prefill(card, toks[:, :19].to(cuda_device), max_len=24)
        assert build.FLASH_ATTENTION.launches == before + cfg.n_layers
        assert _rel(l_card.cpu(), l_cpu) < 1e-4
        for t in (19, 20):
            c_cpu, l_cpu = T.decode_step(cpu, c_cpu, toks[:, t : t + 1])
            c_card, l_card = T.decode_step(card, c_card, toks[:, t : t + 1].to(cuda_device))
            assert _rel(l_card.cpu(), l_cpu) < 1e-4
        full = T.forward(card, toks.to(cuda_device))
        assert _rel(full.cpu(), T.forward(cpu, toks)) < 1e-4


# (arch id, flash launches per prefill, per decode step) of the smoke configs
FAMILY_LAUNCHES = [
    ("olmoe-1b-7b", 2, 0),        # one per layer
    ("kimi-k2-1t-a32b", 2, 0),
    ("mamba2-370m", 0, 0),        # attention-free
    ("zamba2-7b", 2, 0),          # one per shared-block application
    ("whisper-medium", 6, 2),     # encoder + decoder self + cross; cross per step
    ("qwen2-vl-7b", 2, 0),
]


@pytest.mark.parametrize("arch_id,prefill_n,decode_n", FAMILY_LAUNCHES)
def test_family_smoke_model_on_card_matches_cpu(cuda_device, arch_id, prefill_n, decode_n):
    """Every family's smoke model (f32): card logits (the flash kernel on
    every prefill attention and whisper's cross-attention) against CPU
    logits (the plain version) from the same weights, prefill then two
    decode steps, within 1e-4 of the largest; the flash launches counted."""
    from repro_torch import configs
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_arch(arch_id, smoke=True)
    g = torch.Generator().manual_seed(0)
    cpu = T.init_params(cfg, generator=g, device="cpu")
    card = T.params_from_jax(T.params_to_numpy(cpu), cfg, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 21), generator=g)
    fr = (torch.randn((2, cfg.enc_seq, cfg.d_model), generator=g)
          if cfg.family == "audio" else None)
    fr_card = None if fr is None else fr.to(cuda_device)
    with torch.inference_mode():
        c_cpu, l_cpu = T.prefill(cpu, toks[:, :19], max_len=24, frames=fr)
        before = build.FLASH_ATTENTION.launches
        c_card, l_card = T.prefill(card, toks[:, :19].to(cuda_device), max_len=24,
                                   frames=fr_card)
        assert build.FLASH_ATTENTION.launches == before + prefill_n
        assert _rel(l_card.cpu(), l_cpu) < 1e-4
        for t in (19, 20):
            before = build.FLASH_ATTENTION.launches
            c_cpu, l_cpu = T.decode_step(cpu, c_cpu, toks[:, t : t + 1])
            c_card, l_card = T.decode_step(card, c_card, toks[:, t : t + 1].to(cuda_device))
            assert build.FLASH_ATTENTION.launches == before + decode_n
            assert _rel(l_card.cpu(), l_cpu) < 1e-4
        full = T.forward(card, toks.to(cuda_device), frames=fr_card)
        assert _rel(full.cpu(), T.forward(cpu, toks, frames=fr)) < 1e-4


# ----------------------------------------------------------------- SSD scan
# (label, b, L, H, G, N, dh, chunk, initial state): the cell's prefill shape
# at B 2 (4,032 positions: 15 chunks of 256 and one of 192), zamba2-7b's and
# mamba2-370m's widths, the smoke configs' (the instruct smoke's N 8, G 2),
# a cached prefill of a prompt shorter than its chunk (chunk = L = 100, in
# the 128 tile) and a last chunk of one position
SSD_CASES = [
    ("docs4k", 2, 4032, 112, 2, 64, 64, 256, False),
    ("docs4k_state", 2, 4032, 112, 2, 64, 64, 256, True),
    ("zamba2-7b", 2, 1000, 112, 1, 64, 64, 128, True),
    ("mamba2-370m", 2, 1000, 32, 1, 128, 64, 128, True),
    ("smoke", 2, 45, 8, 1, 16, 16, 16, True),
    ("instruct_smoke", 2, 45, 4, 2, 8, 16, 16, True),
    ("short_prompt", 2, 100, 112, 2, 64, 64, 100, True),
    ("ragged_by_one", 1, 513, 112, 2, 64, 64, 256, True),
]


def _ssd_check(ops: dict, chunk: int) -> dict:
    """One launch of the kernel through ``ssd_chunked`` against the plain
    scan (``repro_torch.testing.ssd``'s bound; TF32 off for the plain
    version's f32 products)."""
    from repro_torch.models import ssm
    from repro_torch.testing import ssd as ssd_test

    torch.backends.cuda.matmul.allow_tf32 = False
    before = build.SSD_SCAN.launches
    got = ssm.ssd_chunked(**ops, chunk=chunk, compute_dtype=ops["x"].dtype)
    torch.cuda.synchronize()
    assert build.SSD_SCAN.launches == before + 1
    return ssd_test.agreement(got, ops, chunk)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: c[0])
def test_ssd_scan_kernel_matches_plain(cuda_device, case, dtype):
    """``csrc/ssd_scan.cu`` against ``ssd_chunked_plain`` on the card, x,
    B and C the split views of one conv output: per element within the
    f32 sum order's bound of the terms' magnitudes, plus in bf16 one bf16
    ulp of each of a product's two factors (a score summed in another
    order, or a mask entry, rounded the other way); the norm within the
    bound that a single bf16 rounding of mask * scores misses (CPU twin);
    one launch a call."""
    from repro_torch.testing import ssd as ssd_test

    _, b, L, H, G, N, dh, chunk, initial = case
    ops = ssd_test.ssd_inputs(b, L, H, G, N, dh, dtype, cuda_device, seed=L + H,
                              initial=initial)
    r = _ssd_check(ops, chunk)
    assert ssd_test.holds(r), r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("decay", [(-112.0, 0.1), (-1.0, 1e-3)], ids=["fast", "slow"])
def test_ssd_scan_kernel_at_extreme_decays(cuda_device, decay, dtype):
    """Decays near 0 (A -112, dt 0.1: e^-11.2 a step, the mask and the
    state's carry underflow within a chunk) and near 1 (A -1, dt 1e-3),
    at the cell's widths."""
    from repro_torch.testing import ssd as ssd_test

    ops = ssd_test.ssd_inputs(2, 1000, 112, 2, 64, 64, dtype, cuda_device, seed=7,
                              decay=decay)
    r = _ssd_check(ops, 256)
    assert ssd_test.holds(r), r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_ssd_scan_kernel_against_the_float64_recurrence(cuda_device, dtype):
    """The kernel and the plain chunked scan against the token-by-token
    recurrence (``ssd_sequential``) in float64: the kernel's relative
    error (y and the state) within twice what the plain version reads
    there (the same roundings; f32 sums in another order)."""
    from repro_torch.models import ssm
    from repro_torch.testing import ssd as ssd_test

    torch.backends.cuda.matmul.allow_tf32 = False
    ops = ssd_test.ssd_inputs(1, 600, 112, 2, 64, 64, dtype, cuda_device, seed=11)
    got = ssm.ssd_chunked(**ops, chunk=256, compute_dtype=dtype)
    plain = ssm.ssd_chunked_plain(**ops, chunk=256, compute_dtype=dtype)
    want = ssm.ssd_sequential(*(ops[k].double() for k in ("x", "dt", "A", "Bm", "Cm",
                                                          "initial_state")))

    def rel(a, w):
        return float((a.double() - w).norm() / w.norm())

    for i, what in enumerate(("y", "state")):
        e_k, e_p = rel(got[i], want[i]), rel(plain[i], want[i])
        assert e_k <= 2 * e_p, (what, e_k, e_p)


def test_ssd_scan_runs_once_a_mamba_layer_in_the_prefill(cuda_device):
    """The zamba2-7b-instruct smoke model (f32) on the card: a cached
    prefill and a no-cache forward launch the scan once a mamba layer, a
    decode step (one step of the recurrence) and a forward under autograd
    never; the prefill's logits match the CPU's."""
    from repro_torch import configs
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_arch("zamba2-7b-instruct", smoke=True)
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = T.Transformer(T.weights(cpu, lambda t: t.detach().to(cuda_device)), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    k = build.SSD_SCAN
    with torch.inference_mode():
        before = k.launches
        c_card, l_card = T.prefill(card, toks[:, :37].to(cuda_device), max_len=40)
        assert k.launches == before + cfg.n_layers
        _, l_cpu = T.prefill(cpu, toks[:, :37], max_len=40)
        assert _rel(l_card.cpu(), l_cpu) < 1e-4
        before = k.launches
        T.decode_step(card, c_card, toks[:, 37:38].to(cuda_device))
        assert k.launches == before
        T.forward(card, toks.to(cuda_device))
        assert k.launches == before + cfg.n_layers
    before = k.launches
    T.forward(card, toks.to(cuda_device)).float().sum().backward()
    assert k.launches == before


# (label, b, L, H, G, N, dh, chunk, initial state): the
# granite-4.0-h-small.rag2k cell's prefill at B 2 (1,920 positions: 7
# chunks of 256 and one of 128) on the (128, 64, 256) tile, whose C
# fragments come from device memory, and a last chunk of one position
SSD_CASES_N128 = [
    ("rag2k", 2, 1920, 128, 1, 128, 64, 256, False),
    ("rag2k_state", 2, 1920, 128, 1, 128, 64, 256, True),
    ("ragged_by_one", 1, 513, 128, 1, 128, 64, 256, True),
]


@pytest.mark.parametrize("case", SSD_CASES_N128, ids=lambda c: c[0])
def test_ssd_scan_kernel_matches_plain_at_the_n128_chunk256_tile(cuda_device, case):
    """The (128, 64, 256) tile in bf16 (its only dtype) against
    ``ssd_chunked_plain``, within the per-element bound of
    ``test_ssd_scan_kernel_matches_plain``; one launch a call."""
    from repro_torch.testing import ssd as ssd_test

    _, b, L, H, G, N, dh, chunk, initial = case
    ops = ssd_test.ssd_inputs(b, L, H, G, N, dh, torch.bfloat16, cuda_device, seed=L + H,
                              initial=initial)
    r = _ssd_check(ops, chunk)
    assert ssd_test.holds(r), r


def test_ssd_scan_refuses_float32_at_the_n128_chunk256_tile(cuda_device):
    from repro_torch.kernels import ssd_scan as ssd_lib
    from repro_torch.testing import ssd as ssd_test

    x, dt, A, Bm, Cm, s0 = ssd_test.ssd_inputs(1, 300, 4, 1, 128, 64, torch.float32,
                                              cuda_device).values()
    with pytest.raises(ValueError, match="no float32 instantiation"):
        ssd_lib.ssd_scan(x, dt, A, Bm, Cm, 256, s0)
    ssd_lib.ssd_scan(x, dt, A, Bm, Cm, 128, s0)  # the (128, 64, 128) tile has both
    torch.cuda.synchronize()


def test_ssd_scan_refuses_bad_operands_on_the_card(cuda_device):
    from repro_torch.kernels import ssd_scan as ssd_lib
    from repro_torch.testing import ssd as ssd_test

    ops = ssd_test.ssd_inputs(1, 40, 8, 1, 16, 16, torch.bfloat16, cuda_device)
    x, dt, A, Bm, Cm, s0 = ops.values()
    with pytest.raises(ValueError):
        ssd_lib.ssd_scan(x, dt.cpu(), A, Bm, Cm, 16)
    with pytest.raises(ValueError):  # chunk past the (16, 16) tile
        ssd_lib.ssd_scan(x, dt, A, Bm, Cm, 32)
    with pytest.raises(ValueError):  # rows 2 bytes off 16-byte alignment
        wide = torch.zeros((1, 40, 8, 17), dtype=torch.bfloat16, device=cuda_device)
        ssd_lib.ssd_scan(wide[..., 1:], dt, A, Bm, Cm, 16)
    ssd_lib.ssd_scan(x, dt, A, Bm, Cm, 16, s0)  # well formed
    torch.cuda.synchronize()


# -------------------------------------------------------------- causal conv
# (label, d_inner, G * N, SSD heads): the x | B | C widths of the
# zamba2-7b-instruct.docs4k cell (C 7,424), of mamba2-370m (C 2,304), an
# odd smoke width (C 79: the one-element path in both dtypes) and of the
# granite-4.0-h-small.rag2k cell (C 8,448)
CONV_WIDTHS = [("docs4k", 7168, 128, 112), ("mamba2-370m", 2048, 128, 32),
               ("odd", 61, 9, 3), ("rag2k", 8192, 128, 128)]
CONV_LENGTHS = [1, 2, 3, 5, 256, 4032]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """t's bits, as integers of its width."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _conv_case(dtype, b, L, di, gn, heads, view, dev, seed):
    """The conv's operands: u the x | B | C columns of an in_proj output
    (``view``) or a contiguous copy of them, w, a state and a bias."""
    g = torch.Generator().manual_seed(seed)
    c = di + 2 * gn
    proj = torch.randn((b, L, di + c + heads), generator=g).to(dtype).to(dev)
    u = proj[..., di: di + c]
    w = (torch.randn((4, c), generator=g) * 0.5).to(dtype).to(dev)
    st = torch.randn((b, 3, c), generator=g).to(dtype).to(dev)
    bi = torch.randn((c,), generator=g).to(dtype).to(dev)
    return (u if view else u.contiguous()), w, st, bi


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("view", [True, False], ids=["in_proj_view", "contiguous"])
@pytest.mark.parametrize("width", CONV_WIDTHS, ids=lambda c: c[0])
@pytest.mark.parametrize("L", CONV_LENGTHS)
def test_causal_conv_kernel_is_bit_equal_to_plain(cuda_device, dtype, view, width, L):
    """``csrc/causal_conv.cu`` against ``_causal_conv_plain`` on the card,
    with and without a state and a bias: out and new_state bit-equal; one
    launch a call."""
    from repro_torch.kernels import causal_conv as conv_lib
    from repro_torch.models import ssm

    _, di, gn, heads = width
    u, w, st, bi = _conv_case(dtype, 2, L, di, gn, heads, view, cuda_device, seed=L + di)
    assert conv_lib.vectorized(u, w, st, bi) == (width[0] != "odd")
    for state in (None, st):
        for bias in (None, bi):
            before = build.CAUSAL_CONV.launches
            out, new = ssm._causal_conv(u, w, state, bias)
            torch.cuda.synchronize()
            assert build.CAUSAL_CONV.launches == before + 1
            want_out, want_new = ssm._causal_conv_plain(u, w, state, bias)
            assert out.dtype == new.dtype == dtype and out.is_contiguous()
            key = (state is not None, bias is not None)
            assert torch.equal(_bits(out), _bits(want_out)), key
            assert torch.equal(_bits(new), _bits(want_new)), key


def test_causal_conv_silu_is_torch_silu_on_every_finite_f32(cuda_device):
    """The kernel's SiLU against ``torch.nn.functional.silu`` on the card,
    bit for bit, on every finite f32 value but -0: f32 taps (0, 0, 0, 1)
    and no bias make the conv of a row its own value (-0 becomes +0)."""
    from repro_torch.kernels import causal_conv as conv_lib

    rows, cols = 1 << 14, 1 << 14
    w = torch.tensor([0.0, 0.0, 0.0, 1.0], device=cuda_device)[:, None].expand(4, cols)
    bad = 0
    for lo in range(0, 1 << 32, rows * cols):
        bits = torch.arange(lo, lo + rows * cols, dtype=torch.int64, device=cuda_device)
        bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32)
        u = bits.view(torch.float32)
        keep = torch.isfinite(u) & (bits != -(1 << 31))
        u = torch.where(keep, u, torch.zeros((), device=cuda_device))
        out, _ = conv_lib.causal_conv(u.view(1, rows, cols), w)
        want = torch.nn.functional.silu(u)
        bad += int((out.view(-1).view(torch.int32) != want.view(torch.int32))[keep].sum())
    assert bad == 0, bad


def test_causal_conv_runs_once_a_mamba_layer_in_the_prefill(cuda_device):
    """The zamba2-7b-instruct smoke model on the card, in f32 and in bf16:
    a cached prefill and a no-cache forward launch the conv once a mamba
    layer, a
    decode step and a forward under autograd never; the prefill's logits
    and caches equal those of the same model with the plain conv."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import causal_conv as conv_lib
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    k = build.CAUSAL_CONV
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(configs.get_arch("zamba2-7b-instruct", smoke=True),
                                  dtype=dtype)
        cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        card = T.Transformer(T.weights(cpu, lambda t: t.detach().to(cuda_device)), cfg)
        toks = torch.randint(0, cfg.vocab_size, (2, 40),
                             generator=torch.Generator().manual_seed(1)).to(cuda_device)
        with torch.inference_mode():
            before = k.launches
            c_card, l_card = T.prefill(card, toks[:, :37], max_len=40)
            assert k.launches == before + cfg.n_layers
            real = conv_lib.causal_conv
            conv_lib.causal_conv = lambda *a: ssm._causal_conv_plain(*a)
            try:
                c_plain, l_plain = T.prefill(card, toks[:, :37], max_len=40)
            finally:
                conv_lib.causal_conv = real
            assert torch.equal(_bits(l_card), _bits(l_plain)), dtype
            assert torch.equal(_bits(c_card["conv"]), _bits(c_plain["conv"])), dtype
            before = k.launches
            T.decode_step(card, c_card, toks[:, 37:38])
            assert k.launches == before
            T.forward(card, toks)
            assert k.launches == before + cfg.n_layers
        before = k.launches
        T.forward(card, toks).float().sum().backward()
        assert k.launches == before


def test_causal_conv_refuses_bad_operands_on_the_card(cuda_device):
    from repro_torch.kernels import causal_conv as conv_lib

    u, w, st, bi = _conv_case(torch.bfloat16, 1, 8, 16, 8, 2, True, cuda_device, 0)
    with pytest.raises(ValueError):
        conv_lib.causal_conv(u, w.cpu(), st, bi)
    with pytest.raises(ValueError):
        conv_lib.causal_conv(u, w.float(), st, bi)
    with pytest.raises(ValueError):
        conv_lib.causal_conv(u, w[:3], st, bi)
    conv_lib.causal_conv(u, w, st, bi)  # well formed
    torch.cuda.synchronize()


# ------------------------------------------------------- the decode step
# (label, arch id, smoke): the zamba2-7b-instruct.docs4k cell's mamba layer
# (G 2, N 64, H 112, a conv bias, dt clamped at 1e-3, the grouped norm),
# the granite-4.0-h-small.rag2k cell's (G 1, N 128, H 128, a conv bias, dt
# not clamped) and the 'rmsnorm' form at mamba2-370m's smoke widths (G 1,
# N 16, H 8, dh 16, no bias)
STEP_CASES = [("docs4k", "zamba2-7b-instruct", False),
              ("rag2k", "granite-4.0-h-small", False),
              ("rmsnorm_smoke", "mamba2-370m", True)]


def _step_check(cfg, b: int, dtype, dev, seed: int) -> dict:
    """One decode step of a layer through ``_one_token`` (two launches)
    against ``_one_token_plain`` on the same card, out_proj the identity
    (``repro_torch.testing.ssm_step``); the cache passed in unchanged."""
    from repro_torch.models import ssm
    from repro_torch.testing import ssm_step as step_test

    torch.backends.cuda.matmul.allow_tf32 = False
    p, proj, cache = step_test.step_inputs(cfg, b, dtype, dev, seed=seed)
    kept = {k: v.clone() for k, v in cache.items()}
    before = build.SSM_STEP.launches
    got = ssm._one_token(p, proj, cfg, cache)
    torch.cuda.synchronize()
    assert build.SSM_STEP.launches == before + 2
    assert all(torch.equal(cache[k], kept[k]) for k in cache)
    want = ssm._one_token_plain(p, proj, cfg, cache)
    assert got[0].dtype == got[1]["conv"].dtype == dtype and got[1]["S"].dtype == torch.float32
    return step_test.agreement(got, want, p, proj, cfg, cache)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: c[0])
def test_ssm_step_kernel_matches_plain(cuda_device, case, b, dtype):
    """``csrc/ssm_step.cu`` against ``_one_token_plain`` on the card: the
    new conv state and the new SSM state bit-equal (the plain version's
    order: taps, step sizes, decay, state update), y per element within
    ``repro_torch.testing.ssm_step``'s bound (C . S' and the norm's mean
    summed in another order, and the roundings after them falling the
    other way); the cache passed in unchanged; two launches a call."""
    from repro_torch import configs
    from repro_torch.testing import ssm_step as step_test

    _, arch, smoke = case
    r = _step_check(configs.get_arch(arch, smoke=smoke), b, dtype, cuda_device, seed=b)
    assert step_test.holds(r), r


def test_ssm_step_in_a_cuda_graph_replays_the_eager_result(cuda_device):
    """The step captured in a CUDA graph (as ``DecodeGraph`` captures the
    decode step) and replayed on new inputs gives the eager step's y and
    states bit for bit, at the docs4k cell's widths, B 8, bf16."""
    from repro_torch import configs
    from repro_torch.models import ssm
    from repro_torch.testing import ssm_step as step_test

    cfg = configs.get_arch("zamba2-7b-instruct")
    p, proj, cache = step_test.step_inputs(cfg, 8, torch.bfloat16, cuda_device, seed=1)
    _, proj2, cache2 = step_test.step_inputs(cfg, 8, torch.bfloat16, cuda_device, seed=2)
    s_proj, s_cache = proj.clone(), {k: v.clone() for k, v in cache.items()}
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        ssm._one_token(p, s_proj, cfg, s_cache)  # warm-up
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = build.SSM_STEP.launches
    with torch.cuda.graph(graph):
        out = ssm._one_token(p, s_proj, cfg, s_cache)
    assert build.SSM_STEP.launches == before + 2
    for x, c in ((proj, cache), (proj2, cache2), (proj, cache)):
        s_proj.copy_(x)
        for k in c:
            s_cache[k].copy_(c[k])
        graph.replay()
        want = ssm._one_token(p, x, cfg, c)
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0])
        assert all(torch.equal(out[1][k], want[1][k]) for k in ("conv", "S"))


@pytest.mark.parametrize("arch", ["zamba2-7b-instruct", "granite-4.0-h-small", "mamba2-370m"])
def test_ssm_step_runs_twice_a_mamba_layer_a_decode_step(cuda_device, arch):
    """A smoke model (f32) on the card: a decode step launches the kernels
    twice a mamba layer, a prefill never; three decode steps' logits match
    the CPU's."""
    from repro_torch import configs
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_arch(arch, smoke=True)
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = T.Transformer(T.weights(cpu, lambda t: t.detach().to(cuda_device)), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    k = build.SSM_STEP
    with torch.inference_mode():
        before = k.launches
        c_card, _ = T.prefill(card, toks[:, :37].to(cuda_device), max_len=40)
        c_cpu, _ = T.prefill(cpu, toks[:, :37], max_len=40)
        assert k.launches == before
        for t in range(37, 40):
            before = k.launches
            c_card, l_card = T.decode_step(card, c_card, toks[:, t: t + 1].to(cuda_device))
            assert k.launches == before + 2 * c_card["S"].shape[0]
            c_cpu, l_cpu = T.decode_step(cpu, c_cpu, toks[:, t: t + 1])
            assert _rel(l_card.cpu(), l_cpu) < 1e-4


def test_ssm_step_refuses_bad_operands_on_the_card(cuda_device):
    from repro_torch import configs
    from repro_torch.kernels import ssm_step as step_lib
    from repro_torch.testing import ssm_step as step_test

    cfg = configs.get_arch("zamba2-7b-instruct", smoke=True)
    p, proj, cache = step_test.step_inputs(cfg, 2, torch.bfloat16, cuda_device)
    kw = dict(groups=cfg.ssm_groups, dt_min=cfg.dt_min, norm=cfg.ssm_norm, eps=cfg.norm_eps)
    keys = ("conv_w", "conv_b", "dt_bias", "A_log", "D_skip", "norm")

    def call(p, proj, S, **over):
        return step_lib.ssm_step(proj, cache["conv"], S, *(p[k] for k in keys),
                                 **dict(kw, **over))

    before = build.SSM_STEP.launches
    with pytest.raises(ValueError):
        call(dict(p, conv_w=p["conv_w"].cpu()), proj, cache["S"])
    with pytest.raises(ValueError):
        call(p, proj, cache["S"].to(torch.bfloat16))
    with pytest.raises(ValueError):  # a head dim the kernel does not take
        call(p, proj, cache["S"][..., :6].contiguous())
    with pytest.raises(ValueError):
        call(p, proj, cache["S"].transpose(2, 3))
    with pytest.raises(ValueError):
        call(p, proj, cache["S"], norm="layernorm")
    assert build.SSM_STEP.launches == before
    call(p, proj, cache["S"])  # well formed
    torch.cuda.synchronize()


# ----------------------------------------------------------------- serving
def _serving_fleet():
    """Four integer-grid designs (mus 1/1/1, no stabilizer) in two
    envelopes, with integer initial weights from a seed."""
    from repro_torch.core import simulator

    fleet = {}
    for i in range(4):
        c = ColumnConfig(p=12, q=3 + i % 2, t_max=16 * (1 + (i // 2) % 2),
                         stdp=STDPConfig(mu_capture=1.0, mu_backoff=1.0,
                                         mu_search=1.0, stabilizer="none"))
        fleet[f"d{i}"] = c.with_threshold(simulator.suggest_threshold(c))
    rng = np.random.default_rng(6)
    weights = {n: rng.integers(0, 8, (c.p, c.q)).astype(np.float32)
               for n, c in fleet.items()}
    return fleet, weights


def test_serving_on_card_matches_cpu_and_pins_launches(cuda_device):
    """The streaming service on the card against the same service on the
    CPU (same fleet, weights and stream): equal ids and bit-equal
    weights.  After ``warmup`` each batch is one fire_block launch, each
    re-fit the fused_block launches of ``block_sub_launches``; nothing
    else is launched and nothing is built."""
    from repro_torch.serve import ClusteringService

    fleet, weights = _serving_fleet()
    kw = dict(batch_size=8, refit_every=16, refit_window=16, waste_cap=2.0,
              weights=weights)
    card = ClusteringService(fleet, device=cuda_device, **kw)
    cpu = ClusteringService(fleet, device="cpu", **kw)
    card.warmup()
    cpu.warmup()
    before = {k.name: k.launches for k in build.KERNELS}
    builds, fits = [], []
    orig_build, orig_fit = build.build_all, fused_column.fit_scan_padded

    def record(w, xs, *a, **k):
        fits.append((tuple(w.shape), k["t_window"], k["v_blk"], xs.shape[0]))
        return orig_fit(w, xs, *a, **k)

    build.build_all = lambda *a, **k: builds.append(a) or orig_build(*a, **k)
    fused_column.fit_scan_padded = record
    try:
        rng = np.random.default_rng(2)
        names = card.designs()
        stream = [(rng.normal(size=12), names[s % 4]) for s in range(72)]
        h_card = [card.submit(x, d) for x, d in stream]
        card.flush()
    finally:
        build.build_all, fused_column.fit_scan_padded = orig_build, orig_fit
    h_cpu = [cpu.submit(x, d) for x, d in stream]
    cpu.flush()
    assert [h.result().cluster for h in h_card] == [
        h.result().cluster for h in h_cpu]
    for d in fleet:
        np.testing.assert_array_equal(card.weights(d), cpu.weights(d))
    stats = card.stats()
    assert stats.failed == 0 and stats.refit_failures == 0 and stats.refits >= 2
    launched = {k.name: k.launches - before[k.name] for k in build.KERNELS}
    want = sum(
        len(fused_column.block_sub_launches(p, q, v, min(v, n - s), tw))
        for (_, p, q), tw, v, n in fits for s in range(0, n, v))
    assert len(fits) == stats.refits and not builds
    assert launched["fire_block"] == stats.batches
    assert launched["fused_block"] == want
    for name in ("fused_step", "rnl_fire", "fire_float", "stdp_update",
                 "flash_attention"):
        assert launched[name] == 0, name


def test_serving_durable_dir_recovers_across_devices(cuda_device, tmp_path):
    """A durable directory written on the card, dropped without a drain
    mid-stream, recovers on the card and on the CPU to weights
    bit-identical to the uninterrupted service."""
    from repro_torch.serve import ClusteringService

    fleet, weights = _serving_fleet()
    kw = dict(batch_size=4, refit_every=8, refit_window=8, weights=weights,
              snapshot_every=2)
    rng = np.random.default_rng(3)
    stream = [(rng.normal(size=12), f"d{k % 4}") for k in range(80)]
    live = ClusteringService(fleet, device=cuda_device,
                             durable_dir=str(tmp_path / "svc"), **kw)
    live.warmup()
    for x, d in stream[:60]:
        live.submit(x, d)
    assert live.stats().wal_records > 0
    seq = live._refit_seq
    ref = ClusteringService(fleet, device=cuda_device, **kw)
    ref.warmup()
    for x, d in stream:
        ref.submit(x, d)
        if ref._refit_seq == seq:
            break
    for device in (cuda_device, "cpu"):
        rec = ClusteringService.recover(str(tmp_path / "svc"), device=device)
        assert rec.stats().replayed == live.stats().wal_records
        for d in fleet:
            np.testing.assert_array_equal(rec.weights(d), ref.weights(d))


# ------------------------------------------- baselines and the cost model
def test_kmeans_on_card_matches_cpu(cuda_device):
    from repro_torch.clustering import kmeans
    from repro_torch.data import ucr

    for name in ("ECG200", "WordSynonyms"):
        ds = ucr.load(name)
        cc, cl = kmeans.kmeans(ds.x[:240], ds.n_classes, device=cuda_device)
        hc, hl = kmeans.kmeans(ds.x[:240], ds.n_classes, device="cpu")
        np.testing.assert_array_equal(cl, hl)
        np.testing.assert_allclose(cc, hc, rtol=1e-5, atol=1e-5)


def test_dtcr_step_on_card_matches_cpu(cuda_device):
    """One step's loss and gradients from the same parameters, TF32 off:
    within 1e-4 of the largest (f32 in another summation order)."""
    from repro_torch.clustering import dtcr

    cfg = dtcr.DTCRConfig(hidden=32, n_clusters=2)
    x = np.random.default_rng(0).normal(size=(64, 96)).astype(np.float32)
    params = dtcr.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        p = dtcr._tree_map(lambda t: t.to(dev), params)
        xt = dtcr.normalize(torch.from_numpy(x).to(dev))
        loss, g = dtcr.value_and_grad(p, xt, dtcr.initial_centers(cfg, dev), cfg)
        out[dev.type] = (float(loss), dtcr.params_to_numpy(g))
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    flat = {k: np.concatenate([a.ravel() for a in dtcr._leaves(g)])
            for k, (_, g) in out.items()}
    assert np.abs(flat["cuda"] - flat["cpu"]).max() <= 1e-4 * np.abs(flat["cpu"]).max()


def test_calibrated_sweep_is_bit_equal_to_constants(cuda_device, monkeypatch):
    """A 20-volley integer-grid sweep: the constants fold one block of 20,
    a second run blocks of 16 (``fused_block`` at a second block size);
    weights and ids bit-equal."""
    from repro_torch.core import simulator
    from repro_torch.core.types import ColumnConfig, STDPConfig
    from repro_torch.roofline import costmodel

    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(20, 96)), rng.integers(0, 2, 20)
    grid = STDPConfig(mu_capture=1.0, mu_backoff=1.0, mu_search=1.0,
                      stabilizer="none")
    cfgs = [ColumnConfig(p=96, q=q, t_max=t, stdp=grid)
            for q in (2, 5) for t in (32, 64)]
    cfgs = [c.with_threshold(simulator.suggest_threshold(c)) for c in cfgs]
    w_init = [rng.integers(0, 8, (c.p, c.q)).astype(np.float32) for c in cfgs]

    def run():
        return simulator.cluster_time_series_many(
            x, y, cfgs, epochs=2, w_init=w_init, device=cuda_device)

    const = run()
    with monkeypatch.context() as m:
        m.setattr(costmodel, "const_v_blk",
                  lambda lowering, n_volleys, d=None: min(16, int(n_volleys)))
        blocked = run()
    for a, b in zip(const, blocked):
        assert (a.plan["v_blk"], b.plan["v_blk"]) == (20, 16)
        assert np.array_equal(a.assignments, b.assignments)
        assert torch.equal(a.params["w"], b.params["w"])
