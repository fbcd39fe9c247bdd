"""Port parity, part 2: firing-time solvers, WTA and expected STDP.

Integer weights must give bit-identical spike times; seeded float weights
too (the event solver's prefix sums run in another order than XLA's, so a
crossing within an ulp of an integer could differ — none does on these
inputs).  Random tie-break and stochastic STDP draw from a
``torch.Generator`` and are tested for their own properties only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import neuron as jneuron
from repro.core import stdp as jstdp
from repro.core import wta as jwta
from repro.core.types import NeuronConfig as JNeuron
from repro.core.types import STDPConfig as JSTDP
from repro.core.types import WTAConfig as JWTA
from repro_torch.core import neuron as tneuron
from repro_torch.core import stdp as tstdp
from repro_torch.core import wta as twta
from repro_torch.core.types import NeuronConfig, STDPConfig, WTAConfig


def _inputs(seed, b=12, p=23, q=5, t_max=32, w_max=7, integer=True):
    rng = np.random.default_rng(seed)
    if integer:
        w = rng.integers(0, w_max + 1, (p, q)).astype(np.float32)
    else:
        w = rng.uniform(0, w_max, (p, q)).astype(np.float32)
    t = rng.integers(0, t_max + 6, (b, p)).astype(np.int32)
    return w, t


CASES = [
    # (response, solver, integer weights, threshold)
    ("rnl", "event", True, 20.0), ("rnl", "event", False, 20.0),
    ("rnl", "cycle", True, 20.0), ("rnl", "cycle", False, 33.5),
    ("snl", "event", True, 25.0), ("snl", "event", False, 25.0),
    ("snl", "cycle", True, 25.0), ("lif", "cycle", True, 9.0),
    ("rnl", "event", True, 0.0), ("snl", "event", True, -1.0),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_fire_times_agree(case):
    response, solver, integer, thr = case
    t_max = 32
    w, t = _inputs(len(str(case)), integer=integer)
    jc = JNeuron(response=response, threshold=thr, leak=0.5)
    tc = NeuronConfig(response=response, threshold=thr, leak=0.5)
    j = np.asarray(jneuron.fire_times(jnp.asarray(t), jnp.asarray(w), jc, t_max, solver))
    got = tneuron.fire_times(torch.from_numpy(t), torch.from_numpy(w), tc, t_max, solver)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), j)


@pytest.mark.parametrize("seed", range(4))
def test_event_rnl_float_weights_wider(seed):
    """A wider float-weight check of the event solver (the assignment
    pass of mode='auto'), at the main path's width and window."""
    w, t = _inputs(100 + seed, b=40, p=96, q=4, t_max=64, integer=False)
    cfg = NeuronConfig(threshold=84.0)
    j = np.asarray(jneuron.fire_times_event(jnp.asarray(t), jnp.asarray(w),
                                            JNeuron(threshold=84.0), 64))
    got = tneuron.fire_times_event(torch.from_numpy(t), torch.from_numpy(w), cfg, 64)
    np.testing.assert_array_equal(got.numpy(), j)


def test_event_equals_cycle_on_integer_weights():
    w, t = _inputs(7)
    for resp in ("rnl", "snl"):
        cfg = NeuronConfig(response=resp, threshold=17.0)
        a = tneuron.fire_times(torch.from_numpy(t), torch.from_numpy(w), cfg, 32, "event")
        b = tneuron.fire_times(torch.from_numpy(t), torch.from_numpy(w), cfg, 32, "cycle")
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tneuron.fire_times_event(torch.from_numpy(t), torch.from_numpy(w),
                                 NeuronConfig(response="lif"), 32)


def test_potentials_agree():
    w, t = _inputs(8, integer=False)
    ts = np.arange(0, 40, 3)
    for jf, tf in ((jneuron.rnl_potential, tneuron.rnl_potential),
                   (jneuron.snl_potential, tneuron.snl_potential)):
        j = np.asarray(jf(jnp.asarray(ts), jnp.asarray(t[0]), jnp.asarray(w)))
        got = tf(torch.from_numpy(ts), torch.from_numpy(t[0]), torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), j, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("tie,k", [("index", 1), ("index", 3), ("all", 1), ("all", 2)])
def test_wta_agrees(tie, k):
    rng = np.random.default_rng(k)
    t = rng.integers(0, 10, (30, 6)).astype(np.int32)  # ties are common
    jy, jwin = jwta.wta(jnp.asarray(t), JWTA(k=k, tie_break=tie), 8)
    ty, twin = twta.wta(torch.from_numpy(t), WTAConfig(k=k, tie_break=tie), 8)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))


def test_wta_random_tie_break_properties():
    t = torch.tensor([[3, 3, 3, 9], [5, 2, 2, 7]] * 50, dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    y, win = twta.wta(t, WTAConfig(k=1, tie_break="random"), 8, generator=g)
    assert torch.equal(win.sum(-1), torch.ones(100, dtype=torch.int64))
    assert torch.equal(y.min(-1).values, t.min(-1).values)  # a minimum wins
    firsts = win[0::2].int().argmax(-1)
    assert set(firsts.tolist()) == {0, 1, 2}  # every tied neuron can win
    with pytest.raises(ValueError):
        twta.wta(t, WTAConfig(tie_break="random"), 8)


STDP_CASES = [
    STDPConfig(), STDPConfig(stabilizer="none", mu_capture=1.0, mu_backoff=1.0,
                             mu_search=1.0),
    STDPConfig(mu_capture=0.3, mu_backoff=0.7, mu_search=0.01),
]


@pytest.mark.parametrize("i", range(len(STDP_CASES)))
def test_expected_stdp_agrees(i):
    tc = STDP_CASES[i]
    jc = JSTDP(**{f: getattr(tc, f) for f in tc.__dataclass_fields__})
    rng = np.random.default_rng(i)
    w = (rng.integers(0, 15, (20, 4)) / 2).astype(np.float32)
    w[::3] += rng.uniform(0, 1, (7, 4)).astype(np.float32)
    x = rng.integers(0, 40, 20).astype(np.int32)
    y = rng.integers(0, 40, 4).astype(np.int32)
    args_j = (jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), jc, 7, 32)
    args_t = (torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(y), tc, 7, 32)
    # eager JAX: the arithmetic as written (under jit XLA may rewrite the
    # stabilizer, see ROADMAP §3)
    np.testing.assert_array_equal(
        tstdp.stdp_delta(*args_t).numpy(), np.asarray(jstdp.stdp_delta(*args_j))
    )
    np.testing.assert_array_equal(
        tstdp.stdp_update(*args_t).numpy(), np.asarray(jstdp.stdp_update(*args_j))
    )
    xs = rng.integers(0, 40, (6, 20)).astype(np.int32)
    ys = rng.integers(0, 40, (6, 4)).astype(np.int32)
    jb = np.asarray(jstdp.stdp_update_batch(jnp.asarray(w), jnp.asarray(xs),
                                            jnp.asarray(ys), jc, 7, 32))
    tb = tstdp.stdp_update_batch(torch.from_numpy(w), torch.from_numpy(xs),
                                 torch.from_numpy(ys), tc, 7, 32)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-6, atol=1e-6)


def test_stochastic_stdp_properties():
    cfg = STDPConfig(mode="stochastic", stabilizer="none", mu_capture=0.5,
                     mu_backoff=0.5, mu_search=0.25)
    w = torch.full((400, 3), 3.0)
    x = torch.randint(0, 20, (400,), generator=torch.Generator().manual_seed(1))
    y = torch.tensor([10, 40, 5])
    g = torch.Generator().manual_seed(0)
    new = tstdp.stdp_update(w, x, y, cfg, 7, 32, generator=g)
    d = new - w
    assert set(torch.unique(d).tolist()) <= {-1.0, 0.0, 1.0}  # unit LSB steps
    exp = tstdp.stdp_delta(w, x, y, cfg, 7, 32)
    assert torch.all(torch.sign(d) * torch.sign(exp) >= 0)  # never against it
    # the mean step is the expected one (0.5 capture/backoff, 0.25 search)
    assert abs(d.mean().item() - exp.mean().item()) < 0.06
    again = tstdp.stdp_update(w, x, y, cfg, 7, 32,
                              generator=torch.Generator().manual_seed(0))
    assert torch.equal(new, again)
    with pytest.raises(ValueError):
        tstdp.stdp_update(w, x, y, cfg, 7, 32)
