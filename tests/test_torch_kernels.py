"""Port parity, part 3: the two kernel modules and their plain versions.

On the CPU every wrapper takes its kernel's plain version, so these tests
hold the plain versions (and the host code around the kernels) against
the JAX package: its reference lowering, and its Pallas kernels run in
interpret mode as the JAX package's own tests run them.  The CUDA kernels
themselves are held against the plain versions on the card
(``test_torch_cuda_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core.types import ColumnConfig as JColumn
from repro.core.types import NeuronConfig as JNeuron
from repro.core.types import STDPConfig as JSTDP
from repro.kernels import fused_column as jfc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rnl_response import rnl_fire_pallas
from repro_torch.core import backend
from repro_torch.core.types import ColumnConfig, NeuronConfig, STDPConfig
from repro_torch.kernels import fused_column as tfc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rnl_response


def _weights(rng, shape, w_max=7):
    """Half-integer grid plus some off-grid noise: rounding edges.  Kept
    in [0, w_max], the weights' range by contract."""
    w = rng.integers(0, 2 * w_max + 1, shape).astype(np.float32) / 2
    noise = rng.uniform(0, 0.3, shape).astype(np.float32)
    w = np.where(rng.random(shape) < 0.3, w + noise, w)
    return np.clip(w, 0, w_max).astype(np.float32)


def _hetero_batch(seed=0, d=3, p=37, q=5, t_window=24):
    rng = np.random.default_rng(seed)
    w = _weights(rng, (d, p, q))
    t_in = rng.integers(0, t_window + 6, (d, p)).astype(np.float32)
    thr = np.array([20.0, 35.5, 8.0][:d], np.float32)
    t_maxes = np.array([t_window, t_window - 5, t_window - 9][:d], np.float32)
    q_act = np.array([q, q - 2, 1][:d], np.float32)
    mus = (np.array([0.5, 1.0, 0.25][:d]), np.array([0.5, 0.75, 1.0][:d]),
           np.array([1 / 1024, 0.5, 1.0][:d]))
    return w, t_in, thr, t_maxes, q_act, mus


@pytest.mark.parametrize("stab,k", [(True, 1), (False, 2), (True, 2)])
def test_plain_fused_step_matches_jax_reference(stab, k):
    w, t_in, thr, tm, qa, mus = _hetero_batch(seed=k + 2 * stab)
    ops = tfc.design_operands(thr, tm, qa, *mus)
    w_new, y = tfc.fused_step_padded(
        torch.from_numpy(w), torch.from_numpy(t_in), ops,
        t_window=24, w_max=7, wta_k=k, stabilize=stab,
    )
    for d in range(w.shape[0]):
        jw, jy = jfc.fused_step_ref(
            jnp.asarray(w[d]), jnp.asarray(t_in[d]), float(thr[d]), 24, 7, k,
            float(mus[0][d]), float(mus[1][d]), float(mus[2][d]), stab,
            t_max=int(tm[d]), integer_fire=True, q_active=int(qa[d]),
        )
        np.testing.assert_array_equal(y[d].numpy(), np.asarray(jy, np.float32))
        np.testing.assert_allclose(w_new[d].numpy(), np.asarray(jw),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stab,k", [(True, 1), (False, 2)])
def test_plain_fused_step_matches_pallas_kernel_interpreted(stab, k):
    w, t_in, thr, tm, qa, mus = _hetero_batch(seed=5 + k)
    d, p, q = w.shape
    # the TPU kernel's tile grid: p to 128 lanes, q to 8 sublanes
    w_pad = np.zeros((d, 128, 8), np.float32)
    w_pad[:, :p, :q] = w
    t_pad = np.full((d, 128), 2 * 128, np.float32)
    t_pad[:, :p] = t_in
    jops_ = jfc.design_operands(
        jnp.asarray(thr), jnp.asarray(tm), jnp.asarray(qa),
        jnp.asarray(mus[0], jnp.float32), jnp.asarray(mus[1], jnp.float32),
        jnp.asarray(mus[2], jnp.float32),
    )
    jw, jy = jfc.fused_step_pallas_padded(
        jnp.asarray(w_pad), jnp.asarray(t_pad), jops_, t_window=24, w_max=7,
        wta_k=k, stabilize=stab, interpret=True,
    )
    tw, ty = tfc.fused_step_padded(
        torch.from_numpy(w_pad), torch.from_numpy(t_pad),
        tfc.design_operands(thr, tm, qa, *mus),
        t_window=24, w_max=7, wta_k=k, stabilize=stab,
    )
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)


def test_padded_step_equals_per_design_reference_bit_for_bit():
    """Inside the port the D-design plain step and the one-design
    reference agree exactly (one division, no FMA)."""
    w, t_in, thr, tm, qa, mus = _hetero_batch(seed=11)
    ops = tfc.design_operands(thr, tm, qa, *mus)
    w_new, y = tfc.fused_step_padded_plain(
        torch.from_numpy(w), torch.from_numpy(t_in), ops,
        t_window=24, w_max=7, wta_k=1, stabilize=True,
    )
    for d in range(3):
        rw, ry = tfc.fused_step_ref(
            torch.from_numpy(w[d]), torch.from_numpy(t_in[d]), float(thr[d]), 24,
            7, 1, float(mus[0][d]), float(mus[1][d]), float(mus[2][d]), True,
            t_max=int(tm[d]), integer_fire=True, q_active=int(qa[d]),
        )
        assert torch.equal(y[d], ry.float()) and torch.equal(w_new[d], rw)


@pytest.mark.parametrize("b,p,q,t_max", [(11, 37, 5, 24), (3, 130, 2, 40)])
def test_rnl_fire_matches_pallas_and_reference(b, p, q, t_max):
    rng = np.random.default_rng(b)
    w = np.round(_weights(rng, (p, q)))  # the kernel contract: integer grid
    t = rng.integers(0, t_max + 5, (b, p)).astype(np.int32)
    thr = 0.2 * p * 3.5
    got = rnl_response.rnl_fire(torch.from_numpy(t), torch.from_numpy(w), thr, t_max, 7)
    assert got.dtype == torch.int32
    jp = rnl_fire_pallas(jnp.asarray(t), jnp.asarray(w), thr, t_max, 7, interpret=True)
    jr = jref.rnl_fire_ref(jnp.asarray(t), jnp.asarray(w), thr, t_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jr))
    # the plain version chunks over volleys; chunking changes nothing
    one = torch.cat([rnl_response.rnl_fire_plain(torch.from_numpy(t[i:i + 1]),
                                                 torch.from_numpy(w), thr, t_max, 7)
                     for i in range(b)])
    assert torch.equal(one, got)


def test_reference_oracles_agree():
    rng = np.random.default_rng(4)
    w = np.round(_weights(rng, (19, 4)))
    t = rng.integers(0, 30, (6, 19)).astype(np.int32)
    jw, jt = jnp.asarray(w), jnp.asarray(t)
    tw, tt = torch.from_numpy(w), torch.from_numpy(t)
    np.testing.assert_array_equal(tref.rnl_fire_ref(tt, tw, 17.0, 24).numpy(),
                                  np.asarray(jref.rnl_fire_ref(jt, jw, 17.0, 24)))
    np.testing.assert_array_equal(
        tref.rnl_fire_ref_planes(tt, tw, 17.0, 24, 7).numpy(),
        np.asarray(jref.rnl_fire_ref_planes(jt, jw, 17.0, 24, 7)))
    times = rng.integers(0, 9, (10, 6)).astype(np.int32)
    for k in (1, 2, 4):
        np.testing.assert_array_equal(
            tref.wta_ref(torch.from_numpy(times), k, 8).numpy(),
            np.asarray(jref.wta_ref(jnp.asarray(times), k, 8)))
    x, y = t[0], rng.integers(0, 30, 4).astype(np.int32)
    wf = _weights(rng, (19, 4))
    for stab in (True, False):
        np.testing.assert_array_equal(
            tref.stdp_ref(torch.from_numpy(wf), torch.from_numpy(x),
                          torch.from_numpy(y), 0.5, 0.5, 1 / 1024, 7, 24,
                          stabilize=stab).numpy(),
            np.asarray(jref.stdp_ref(jnp.asarray(wf), jnp.asarray(x), jnp.asarray(y),
                                     0.5, 0.5, 1 / 1024, 7, 24, stabilize=stab)))


def test_fire_dense_ref_agrees_for_both_responses():
    rng = np.random.default_rng(9)
    w = _weights(rng, (15, 3))
    t = rng.integers(0, 20, 15).astype(np.int32)
    for resp in ("rnl", "snl"):
        for t_max in (16, 20):
            j = jfc.fire_dense_ref(jnp.asarray(w), jnp.asarray(t), 9.0, 20,
                                   t_max=t_max, response=resp)
            got = tfc.fire_dense_ref(torch.from_numpy(w), torch.from_numpy(t), 9.0,
                                     20, t_max=t_max, response=resp)
            np.testing.assert_array_equal(got.numpy(), np.asarray(j))


def _int_cfgs(p=19, q=4, t_max=24, threshold=7.0):
    """Integer mus, no stabilizer: weights stay on the integer grid."""
    kw = dict(mu_capture=1.0, mu_backoff=1.0, mu_search=1.0, stabilizer="none")
    return (
        JColumn(p=p, q=q, t_max=t_max, neuron=JNeuron(threshold=threshold),
                stdp=JSTDP(**kw)),
        ColumnConfig(p=p, q=q, t_max=t_max, neuron=NeuronConfig(threshold=threshold),
                     stdp=STDPConfig(**kw)),
    )


def test_event_cycle_fused_bit_identical_on_integer_grid():
    _, cfg = _int_cfgs()
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy(rng.integers(0, 8, (19, 4)).astype(np.float32))
    x = torch.from_numpy(rng.integers(0, 30, (12, 19)).astype(np.int32))
    outs = {}
    for name in ("event", "cycle", "pallas"):
        p2, ys = backend.get(name).fit({"w": w0}, x, cfg, name, 3, None, True, None)
        outs[name] = (p2["w"], ys)
    for name in ("cycle", "pallas"):
        assert torch.equal(outs["event"][1], outs[name][1]), name
        assert torch.equal(outs["event"][0], outs[name][0]), name


@pytest.mark.parametrize("stab", [True, False])
def test_fit_fused_trace_matches_jax_reference(stab):
    jcfg = JColumn(p=21, q=3, t_max=20, neuron=JNeuron(threshold=11.0),
                   stdp=JSTDP(stabilizer="half" if stab else "none"))
    cfg = ColumnConfig(p=21, q=3, t_max=20, neuron=NeuronConfig(threshold=11.0),
                       stdp=STDPConfig(stabilizer="half" if stab else "none"))
    rng = np.random.default_rng(2)
    w0 = _weights(rng, (21, 3))
    x = rng.integers(0, 24, (10, 21)).astype(np.int32)
    jp, jy = jfc.fit_fused({"w": jnp.asarray(w0)}, jnp.asarray(x), jcfg,
                           epochs=2, lowering="reference", trace=True)
    tp, ty = tfc.fit_fused({"w": torch.from_numpy(w0)}, torch.from_numpy(x), cfg,
                           epochs=2, lowering="reference", trace=True)
    assert ty.shape == (2, 10, 3) and ty.dtype == torch.int32
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-6)
    # the kernel's host loop (D = 1 padded steps) on CPU tensors: the same
    # fit, bit for bit
    cp, cy = tfc.fit_fused({"w": torch.from_numpy(w0)}, torch.from_numpy(x), cfg,
                           epochs=2, lowering="cuda", trace=True)
    assert torch.equal(cy, ty) and torch.equal(cp["w"], tp["w"])
    np.testing.assert_array_equal(w0, _weights(np.random.default_rng(2), (21, 3)))


def test_fusable_contract_and_lowering_probe():
    _, cfg = _int_cfgs()
    tfc.check_fusable(cfg, "cuda")
    snl = ColumnConfig(p=4, q=2, neuron=NeuronConfig(response="snl"))
    tfc.check_fusable(snl, "reference")
    with pytest.raises(ValueError):
        tfc.check_fusable(snl, "cuda")
    with pytest.raises(ValueError):
        tfc.check_fusable(cfg, "mosaic")
    assert backend.lowering(torch.zeros(1)) == "reference"
    assert backend.padded_lowering("snl", torch.zeros(1)) == "reference"
    assert tfc.LOWERINGS == ("cuda", "reference")
    assert tfc.OPERAND_COLS == jfc.OPERAND_COLS
    x = tfc._pad_volleys_silent(torch.tensor([[1, 2]], dtype=torch.int32), 4, 9.0)
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jfc._pad_volleys_silent(jnp.asarray([[1, 2]]), 4, 9.0)))


def test_column_forward_matches_jax():
    jcfg, cfg = _int_cfgs(p=30, q=6, t_max=32, threshold=40.0)
    rng = np.random.default_rng(12)
    w = _weights(rng, (30, 6))
    t = rng.integers(0, 36, (9, 30)).astype(np.int32)
    j = jops.column_forward({"w": jnp.asarray(w)}, jnp.asarray(t), jcfg,
                            use_pallas=False)
    got = tops.column_forward({"w": torch.from_numpy(w)}, torch.from_numpy(t), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))
    assert jbackend.resolve("auto", jcfg, training=True) == \
        backend.resolve("auto", cfg, training=True) == "pallas"
