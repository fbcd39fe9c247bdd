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
from repro_torch.kernels import build, fused_column, rnl_response

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


def test_fit_fused_on_card_matches_cpu_reference(cuda_device):
    cfg = ColumnConfig(p=40, q=6, t_max=32, neuron=NeuronConfig(threshold=30.0))
    rng = np.random.default_rng(3)
    w0 = torch.from_numpy(_half_grid_weights(rng, (40, 6)))
    x = torch.from_numpy(rng.integers(0, 36, (20, 40)).astype(np.int32))
    assert backend.lowering(w0.to(cuda_device)) == "cuda"
    p_ref, y_ref = fused_column.fit_fused({"w": w0}, x, cfg, 3, "reference", True)
    p_k, y_k = fused_column.fit_fused(
        {"w": w0.to(cuda_device)}, x.to(cuda_device), cfg, 3, "cuda", True
    )
    assert torch.equal(y_k.cpu(), y_ref)
    assert torch.equal(p_k["w"].cpu(), p_ref["w"])


def test_wrappers_refuse_bad_operands(cuda_device):
    w = torch.zeros((1, 8, 2), device=cuda_device)
    t = torch.zeros((1, 8), device=cuda_device)
    ops = fused_column.design_operands([1.0], [8], [2], 0.5, 0.5, 0.5).to(cuda_device)
    kw = dict(t_window=8, w_max=7, wta_k=1, stabilize=True)
    with pytest.raises(ValueError):
        fused_column.fused_step_padded(w.double(), t, ops, **kw)
    with pytest.raises(ValueError):
        fused_column.fused_step_padded(w, t.cpu(), ops, **kw)
    with pytest.raises(ValueError):  # 227 KB of shared memory is the limit
        big = torch.zeros((1, 4000, 8), device=cuda_device)
        fused_column.fused_step_padded(
            big, torch.zeros((1, 4000), device=cuda_device), ops, **kw
        )
    with pytest.raises(ValueError):
        rnl_response.rnl_fire(t, w[0].double(), 1.0, 8, 7)
    rnl_response.rnl_fire(t, w[0], 1.0, 8, 7)  # the same call, well formed
