"""Port parity, part 6: the STDP-update kernel's module and the ``ops``
entry point.

The JAX package and the port run the same numpy-seeded inputs on the CPU.
The port's ``stdp_update`` (its plain version on CPU tensors) must equal
the JAX package's ``stdp_update_pallas`` (run as its own tests run it,
interpreted off the TPU) bit for bit: both compute the stabilizer in the
form XLA compiles the kernel to.  The eager reference forms agree bit for
bit too, and the fused ``ops.train_volleys`` equals the JAX package's
reference lowering bit for bit.  The CUDA kernel itself is held against
the plain version on the card (``tests/test_torch_cuda_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jencoding
from repro.core import simulator as jsim
from repro.core.types import ColumnConfig as JColumn
from repro.core.types import STDPConfig as JSTDP
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.stdp_update import stdp_update_pallas
from repro_torch.core import encoding, simulator
from repro_torch.core.types import ColumnConfig, STDPConfig
from repro_torch.data import ucr
from repro_torch.kernels import build, ops, ref, stdp_update

SHAPES = [(13, 3), (270, 25), (650, 130), (7, 1)]
MUS = (0.5, 0.5, 1 / 1024)


def _inputs(p, q, dtype, seed=0, t_max=16):
    """Weights from uniform(0, 7) with a few outside [0, 7] and at x.5;
    times with silent entries (>= t_max) on both axes."""
    rng = np.random.default_rng(seed + p * 31 + q)
    w = rng.uniform(0, 7, (p, q)).astype(np.float32)
    extra = np.array([-0.5, 7.5, 3.5, 0.5, 9.0, 6.5], np.float32)
    w.flat[: min(w.size, extra.size)] = extra[: w.size]
    x = rng.integers(0, t_max + 6, p).astype(dtype)
    y = rng.integers(0, t_max + 6, q).astype(dtype)
    x[0], y[-1] = t_max, t_max + 3
    return w, x, y


@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["int32", "f32"])
@pytest.mark.parametrize("stabilize", [True, False], ids=["stab", "plain"])
@pytest.mark.parametrize("p,q", SHAPES)
def test_stdp_update_equals_jax_kernel_bit_for_bit(p, q, stabilize, dtype):
    w, x, y = _inputs(p, q, dtype)
    want = np.asarray(stdp_update_pallas(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), *MUS, 7, 16,
        stabilize=stabilize))
    before = build.STDP_UPDATE.launches
    got = stdp_update.stdp_update(
        torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(y), *MUS,
        7, 16, stabilize=stabilize)
    assert build.STDP_UPDATE.launches == before  # the CPU runs the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (p, q)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stabilize", [True, False], ids=["stab", "plain"])
@pytest.mark.parametrize("p,q", SHAPES)
def test_ops_stdp_step_equals_jax(p, q, stabilize):
    w, x, y = _inputs(p, q, np.int32, seed=1)
    stdp = dict(mu_capture=0.5, mu_backoff=0.25, mu_search=1 / 512,
                stabilizer="half" if stabilize else "none")
    jcfg = JColumn(p=p, q=q, t_max=16, stdp=JSTDP(**stdp))
    cfg = ColumnConfig(p=p, q=q, t_max=16, stdp=STDPConfig(**stdp))
    want = np.asarray(jops.stdp_step(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), jcfg))
    got = ops.stdp_step(torch.from_numpy(w), torch.from_numpy(x),
                        torch.from_numpy(y), cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    # the JAX package's eager path is the source's form, as is the port's
    # ref.stdp_ref default; both agree with the compiled form to 1e-6
    # (the JAX package's own bound, tests/test_kernels.py)
    eager = np.asarray(jops.stdp_step(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), jcfg, use_pallas=False))
    np.testing.assert_allclose(got.numpy(), eager, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stabilize", [True, False], ids=["stab", "plain"])
@pytest.mark.parametrize("p,q", SHAPES)
def test_source_form_equals_eager_jax(p, q, stabilize):
    w, x, y = _inputs(p, q, np.int32, seed=2)
    want = np.asarray(jref.stdp_ref(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), *MUS, 7, 16,
        stabilize=stabilize))
    got = ref.stdp_ref(torch.from_numpy(w), torch.from_numpy(x),
                       torch.from_numpy(y), *MUS, 7, 16, stabilize=stabilize)
    np.testing.assert_array_equal(got.numpy(), want)


def _volleys(name, n, t_max):
    ds = ucr.load(name)
    x = np.array(jencoding.latency_encode(
        jnp.asarray(ds.x[:n], jnp.float32), t_max))
    got = encoding.latency_encode(torch.as_tensor(ds.x[:n], dtype=torch.float32),
                                  t_max)
    np.testing.assert_array_equal(got.numpy(), x)
    return x


@pytest.mark.parametrize("stabilize", [True, False], ids=["stab", "grid"])
def test_train_volleys_equals_jax_reference(stabilize):
    stdp = ({} if stabilize else dict(mu_capture=1.0, mu_backoff=1.0,
                                      mu_search=1.0, stabilizer="none"))
    jcfg = JColumn(p=65, q=2, t_max=32, stdp=JSTDP(**stdp))
    jcfg = jcfg.with_threshold(jsim.suggest_threshold(jcfg))
    cfg = ColumnConfig(p=65, q=2, t_max=32, stdp=STDPConfig(**stdp))
    cfg = cfg.with_threshold(simulator.suggest_threshold(cfg))
    x = _volleys("SonyAIBORobotSurface2", 40, 32)
    rng = np.random.default_rng(3)
    w0 = rng.uniform(0, 7, (65, 2)).astype(np.float32)
    if not stabilize:
        w0 = np.round(w0)
    want = np.asarray(jops.train_volleys(
        {"w": jnp.asarray(w0)}, jnp.asarray(x), jcfg, use_pallas=False)["w"])
    before = build.FUSED_STEP.launches
    got = ops.train_volleys({"w": torch.from_numpy(w0)}, torch.from_numpy(x), cfg)
    assert build.FUSED_STEP.launches == before
    np.testing.assert_array_equal(got["w"].numpy(), want)


def test_unfused_ops_loop_equals_train_volleys():
    """column_forward + stdp_step, volley by volley, is the online rule
    that train_volleys fuses: equal weights bit for bit (the JAX package
    gives the same equality between its ops loop and train_volleys)."""
    cfg = ColumnConfig(p=96, q=2, t_max=64)
    cfg = cfg.with_threshold(simulator.suggest_threshold(cfg))
    x = torch.from_numpy(_volleys("ECG200", 50, 64))
    rng = np.random.default_rng(4)
    w0 = torch.from_numpy(rng.uniform(0, 7, (96, 2)).astype(np.float32))
    w = w0.clone()
    for i in range(x.shape[0]):
        y = ops.column_forward({"w": w}, x[i : i + 1], cfg)
        w = ops.stdp_step(w, x[i], y[0], cfg)
    fused = ops.train_volleys({"w": w0}, x, cfg)["w"]
    assert torch.equal(w, fused)
    assert not torch.equal(w, w0)
