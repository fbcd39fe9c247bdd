"""Port parity, part 7: the flash-attention kernel's module, and the
shared-memory layouts of the four TNN fire kernels.

The JAX package and the port run the same numpy-seeded inputs on the CPU.
The port's ``flash_attention`` (its plain version, ``chunked_attention``
on the grouped view, on CPU tensors) must match the JAX package's
``flash_attention_pallas``, run as its own tests run it (interpreted off
the TPU) on K and V repeated to the query heads, within that test's
tolerances: 2e-5 of the largest output in f32, 2e-2 in bf16 (where the
plain version rounds the probabilities to bf16 and the TPU kernel keeps
them in f32).  The CUDA kernel itself is held against the plain version on
the card (``tests/test_torch_cuda_kernels.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch import configs
from repro_torch.kernels import build, flash_attention as flash_lib
from repro_torch.models import layers


def _qkv(rng, b, s, h, hkv, d, skv=None):
    skv = s if skv is None else skv
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    return q, k, v


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _jax_flash(q, k, v, causal, dtype=jnp.float32):
    """The TPU kernel, interpreted, on K and V repeated to q's heads."""
    g = q.shape[2] // k.shape[2]
    kr = jnp.repeat(jnp.asarray(k, dtype), g, axis=2)
    vr = jnp.repeat(jnp.asarray(v, dtype), g, axis=2)
    return flash_attention_pallas(jnp.asarray(q, dtype), kr, vr, causal=causal)


# the shapes of the JAX package's tests/test_flash_attention.py, each with
# grouped KV heads where the head count allows
@pytest.mark.parametrize("B,S,H,Hkv,d,causal", [
    (2, 256, 4, 2, 64, True),
    (1, 128, 2, 1, 32, False),
    (2, 384, 3, 1, 128, True),
    (1, 512, 1, 1, 64, True),
    # head dim 112 (kimi-k2, zamba2): GQA 8:1 and MHA, causal and not
    (1, 256, 8, 1, 112, True),
    (2, 128, 4, 4, 112, False),
    (1, 256, 2, 2, 112, True),
])
def test_flash_plain_matches_jax_kernel(B, S, H, Hkv, d, causal):
    rng = np.random.default_rng(B * S + H)
    q, k, v = _qkv(rng, B, S, H, Hkv, d)
    want = np.asarray(_jax_flash(q, k, v, causal))
    before = build.FLASH_ATTENTION.launches
    got = flash_lib.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    assert build.FLASH_ATTENTION.launches == before  # the CPU runs the plain version
    assert got.shape == (B, S, H, d) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) < 2e-5


def test_flash_plain_matches_jax_kernel_bf16():
    for d in (64, 112):  # 112: kimi-k2's and zamba2's head dim
        rng = np.random.default_rng(7)
        q, k, v = _qkv(rng, 1, 128, 4, 2, d)
        want = np.asarray(_jax_flash(q, k, v, True, jnp.bfloat16), np.float32)
        got = flash_lib.flash_attention(
            *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), True)
        assert got.dtype == torch.bfloat16
        assert _rel_err(got.float().numpy(), want) < 2e-2  # bf16 I/O tolerance


@pytest.mark.parametrize("kv_chunk", [16, 64, 1024])
def test_flash_plain_is_chunk_invariant_on_ragged_lengths(kv_chunk):
    """Sq = 100 and Skv = 100 (tails of every chunk size), causal and not:
    the chunk only moves rounding."""
    rng = np.random.default_rng(100)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 100, 4, 2, 32))
    ref = flash_lib.flash_attention_plain(q, k, v, True, kv_chunk=100)
    got = flash_lib.flash_attention_plain(q, k, v, True, kv_chunk=kv_chunk)
    assert _rel_err(got, ref) < 2e-6
    # the first query sees only the first key: its output is v[0]
    g = 2
    assert torch.allclose(got[:, 0], v[:, 0].repeat_interleave(g, dim=1), atol=1e-6)
    full = flash_lib.flash_attention_plain(q, k, v, False, kv_chunk=kv_chunk)
    assert not torch.allclose(full, got)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 8, 2, 16))
    # the kernel path's checks refuse CPU tensors and mixed devices
    with pytest.raises(ValueError, match="CUDA"):
        flash_lib._check_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        flash_lib.flash_attention(q, kv.to("meta"), kv)
    # bf16 scores are an option of the plain version only: the model's
    # attention refuses them off the CPU
    cfg = dataclasses.replace(configs.get_arch("granite-3-8b", smoke=True),
                              attn_bf16_scores=True)
    with pytest.raises(NotImplementedError):
        layers._attend(q.to("meta"), kv.to("meta"), kv.to("meta"), True, cfg)
    before = build.FLASH_ATTENTION.launches
    out = flash_lib.flash_attention(q, kv, kv)  # CPU: the plain version
    assert out.shape == q.shape and build.FLASH_ATTENTION.launches == before



@pytest.mark.parametrize("bf16_scores", [False, True])
def test_model_attention_gives_the_plain_version_its_config_on_the_cpu(bf16_scores):
    """On CPU tensors the model's attention runs the plain version with the
    config's KV chunk and score dtype (the kernel wrapper takes neither)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(rng, 1, 40, 4, 2, 16))
    cfg = dataclasses.replace(configs.get_arch("granite-3-8b", smoke=True),
                              kv_chunk=16, attn_bf16_scores=bf16_scores)
    got = layers._attend(q, k, v, True, cfg)
    want = flash_lib.flash_attention_plain(q, k, v, True, kv_chunk=16,
                                           bf16_scores=bf16_scores)
    assert torch.equal(got, want)
    if bf16_scores:  # the option reaches the plain version
        assert not torch.equal(got, flash_lib.flash_attention(q, k, v, True))


def test_flash_elementwise_bound_separates_rounding_from_a_wrong_tile():
    """The card check of the bf16 kernel (chip_smoke phase 14): per element
    against the plain version in f32 on the same bf16 values, within one
    bf16 rounding (2^-8 |ref|) plus 1e-5 of the largest output.  What a
    right kernel gives (f32 math, one rounding) passes it; the bf16 plain
    version itself is no per-element yardstick (its bf16 probabilities move
    rows whose values cancel); and a 1% error on the late rows, which the
    2e-2-of-the-largest check lets through, fails it."""
    b, s, hq, hkv, d = 1, 2048, 8, 2, 128
    g = torch.Generator().manual_seed(s + d)
    q, k, v = (torch.randn(sh, generator=g).to(torch.bfloat16)
               for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    ref16 = flash_lib.flash_attention_plain(q, k, v, True).float()
    ref32 = flash_lib.flash_attention_plain(q.float(), k.float(), v.float(), True)
    right = ref32.to(torch.bfloat16).float()
    bound = 2.0 ** -8 * ref32.abs() + 1e-5 * ref32.abs().max()
    assert bool(((right - ref32).abs() <= bound).all())
    assert bool(((right - ref16).abs() > 2 * 2.0 ** -8 * ref16.abs() + 1e-3).any())
    wrong = right.clone()
    wrong[:, 1900:] *= 1.01
    assert bool(((wrong - ref32).abs() > bound).any())
    assert _rel_err(wrong.numpy(), ref16.numpy()) < 2e-2

# ------------------------------------- shared-memory layouts (the repair)
# Each kernel's csrc formula, with ``resident`` its layout argument.
def _fused_step_smem(p, q, t_window, resident=True):
    # csrc/fused_step.cu: tnn_fused_step_smem_bytes (the weights, two
    # volleys in flight, no integer grid; the fire's slope histogram, q
    # rows of t_window + 1 ints)
    return (p * q * resident + 2 * p + q) * 4 + (q + q * (t_window + 1)) * 4


def _fused_block_smem(p, q, v_blk, t_window, resident=True):
    # csrc/fused_block.cu: tnn_fused_block_smem_bytes (no integer grid; the
    # fire's slope histogram, q rows of t_window + 1 ints)
    return (p * q * resident + v_blk * p + q) * 4 + (q + q * (t_window + 1)) * 4


def _rnl_fire_smem(p, q, t_max, resident=True):
    # csrc/rnl_fire.cu: tnn_rnl_fire_smem_bytes (a tile of 2 volleys; one
    # difference row of t_max + 1 ints for each of the block's 8 warps)
    return (p * q * resident + 2 * p) * 4 + 8 * (t_max + 1) * 4


def _fire_block_smem(p, q, t_window, resident=True):
    # csrc/fire_block.cu: tnn_fire_block_smem_bytes (a tile of 8 volleys;
    # one difference row of t_window + 1 ints for each of the block's 16
    # warps)
    return (p * q * resident + 8 * p) * 4 + 16 * (t_window + 1) * 4


def _fire_float_smem(p, q, t_window, resident=True):
    # csrc/fire_float.cu: tnn_fire_float_smem_bytes (the unrounded weights;
    # a tile of 8 volleys; for each of the block's 16 warps a float64 row
    # and an int row of t_window + 1; a float64 constant for each neuron)
    return (16 * (t_window + 1) + q) * 8 + (p * q * resident + 8 * p) * 4 + (
        16 * (t_window + 1) * 4)


@pytest.fixture
def smem_formulas(monkeypatch):
    for k, f in ((build.FUSED_STEP, _fused_step_smem),
                 (build.FUSED_BLOCK, _fused_block_smem),
                 (build.RNL_FIRE, _rnl_fire_smem),
                 (build.FIRE_BLOCK, _fire_block_smem),
                 (build.FIRE_FLOAT, _fire_float_smem)):
        monkeypatch.setattr(k, "smem_bytes", f)


def _layouts(p, q) -> dict:
    return {
        "fused_step": build.FUSED_STEP.resident("", p, q, 64),
        "fused_block": build.FUSED_BLOCK.resident("", p, q, 1, 64),
        "rnl_fire": build.RNL_FIRE.resident("", p, q, 64),
        "fire_block": build.FIRE_BLOCK.resident("", p, q, 64),
        "fire_float": build.FIRE_FLOAT.resident("", p, q, 64),
    }


@pytest.mark.parametrize("p,q,want", [
    (270, 25, dict(fused_step=True, fused_block=True, rnl_fire=True, fire_block=True,
                   fire_float=True)),
    (540, 50, dict(fused_step=True, fused_block=True, rnl_fire=True, fire_block=True,
                   fire_float=True)),
    # Lightning2 at q = 50: a fit needs 145,896 B for the weights, two
    # volleys and the histogram in fused_step, 143,348 B beside the
    # weights and the histogram in fused_block, while the fire kernels'
    # grid, tile and warp rows need 134,576 B (rnl_fire) and 151,944 B
    # (fire_block), and fire_float's weights, tile and rows 160,664 B
    (637, 50, dict(fused_step=True, fused_block=True, rnl_fire=True, fire_block=True,
                   fire_float=True)),
    (650, 130, dict(fused_step=False, fused_block=False, rnl_fire=False, fire_block=False,
                   fire_float=False)),
    # rnl_fire's tile of 2 volleys leaves room for a 4000 x 8 grid
    (4000, 8, dict(fused_step=True, fused_block=True, rnl_fire=True, fire_block=False,
                   fire_float=False)),
    (4000, 16, dict(fused_step=False, fused_block=False, rnl_fire=False, fire_block=False,
                   fire_float=False)),
    (6000, 10, dict(fused_step=False, fused_block=False, rnl_fire=False, fire_block=False,
                   fire_float=False)),
])
def test_kernels_take_the_resident_layout_wherever_it_fits(smem_formulas, p, q, want):
    assert _layouts(p, q) == want
    assert _fused_step_smem(637, 50, 64) == 145_896
    assert _fused_block_smem(637, 50, 1, 64) == 143_348
    assert _rnl_fire_smem(637, 50, 64) == 134_576
    assert _fire_block_smem(637, 50, 64) == 151_944
    assert _fire_float_smem(637, 50, 64) == 160_664
    assert _fire_float_smem(540, 50, 64) == 138_160  # the on/off envelope


def test_device_layout_blocks_split_by_the_same_formula(smem_formulas):
    """In the device-memory layout a block of 32 volleys at 650 x 130 fits
    in one launch; at 6000 x 10 it splits into the volleys that fit beside
    the firing times and the histogram alone."""
    from repro_torch.kernels import fused_column

    assert fused_column.block_sub_launches(650, 130, 32, 32, 64) == [(0, 32, 32)]
    v_fit = (build.MAX_SMEM_BYTES
             - _fused_block_smem(6000, 10, 0, 64, False)) // (4 * 6000)
    assert v_fit == 9
    plan = fused_column.block_sub_launches(6000, 10, 32, 30, 64)
    assert plan == [(0, 9, 9), (9, 9, 9), (18, 9, 9), (27, 3, 3)]
    # the resident envelopes split by the same formula
    assert fused_column.block_sub_launches(637, 50, 32, 32, 64) == [(0, 32, 32)]
    assert fused_column.block_sub_launches(4000, 8, 32, 30, 64)[0] == (0, 6, 6)


def test_layout_refuses_what_fits_in_neither(smem_formulas):
    with pytest.raises(ValueError, match="even with its weights in device memory"):
        build.FUSED_STEP.resident("a 60000 x 8 envelope", 60000, 8, 64)
