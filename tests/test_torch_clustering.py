"""Port parity of the Table II baselines: k-means and the DTCR-like model.

The same numpy inputs (and, for DTCR, the JAX package's initial
parameters carried across with ``dtcr.params_from_jax``) go through both
packages on the CPU.  Tolerances, and why they hold:

* k-means: labels equal, centers within ``rtol=atol=1e-5``.  Both
  packages seed with the same numpy k-means++ draw and run the same f32
  Lloyd steps; only the summation order of the distances and the
  per-cluster sums differs (XLA against ATen), a few f32 ulps of centers
  of magnitude ~1.
* DTCR forward (``encode``, ``decode``, the loss): within 1e-5 absolute.
  Each GRU cell is the same f32 algebra; the products sum in another
  order, which moves states bounded by 1 by a few ulps per step over 32
  steps.
* DTCR gradients and five Adam steps: within 1e-4 of the largest.
  Back-propagation through five 32-step scans accumulates the forward's
  ulps; Adam divides by ``sqrt(v)``, which scales those differences by
  at most ``lr / sqrt(v)`` per step.
* ``fit_predict``: labels equal.  The fake samples equal the series in
  both packages, so no random stream touches the data after the initial
  parameters; the final k-means on the representation separates the
  clusters far beyond the packages' f32 difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.clustering import dtcr as jdtcr
from repro.clustering import kmeans as jkmeans
from repro.clustering.metrics import rand_index
from repro.data import ucr
from repro_torch.clustering import dtcr, kmeans


# ---------------------------------------------------------------- k-means
def _separated():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(0, 0.2, (40, 4)), rng.normal(5, 0.2, (40, 4))
    ])
    return x, 2


def _double(name):
    ds = ucr.load(name)
    return ds.x[:120], ds.n_classes


KMEANS_CASES = {"separated": _separated, "ECG200": lambda: _double("ECG200"),
                "Beef": lambda: _double("Beef")}


@pytest.mark.parametrize("case", sorted(KMEANS_CASES))
def test_kmeans_matches_jax(case):
    x, k = KMEANS_CASES[case]()
    jc, jl = jkmeans.kmeans(x, k, seed=0)
    tc, tl = kmeans.kmeans(x, k, seed=0, device="cpu")
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(KMEANS_CASES))
def test_kmeans_chooses_the_same_restart(case):
    """Restart by restart from the same numpy seeding: the same Lloyd
    result in both packages, and the least inertia at the same restart."""
    x, k = KMEANS_CASES[case]()
    j_rng, t_rng = np.random.default_rng(0), np.random.default_rng(0)
    xj = jnp.asarray(x, jnp.float32)
    xt = torch.as_tensor(np.asarray(x, np.float32))
    j_in, t_in = [], []
    for _ in range(4):
        c0 = jkmeans._plusplus_init(j_rng, np.asarray(x, np.float64), k)
        np.testing.assert_array_equal(
            kmeans._plusplus_init(t_rng, np.asarray(x, np.float64), k), c0)
        jc, jl = jkmeans._lloyd(xj, jnp.asarray(c0, jnp.float32), 50)
        tc, tl = kmeans._lloyd(xt, torch.as_tensor(c0.astype(np.float32)), 50)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        j_in.append(float(((xj - jc[jl]) ** 2).sum()))
        t_in.append(float(((xt - tc[tl]) ** 2).sum()))
    assert int(np.argmin(t_in)) == int(np.argmin(j_in))
    np.testing.assert_allclose(t_in, j_in, rtol=1e-5)


def test_kmeans_recovers_separated_clusters():
    x, k = _separated()
    y = np.array([0] * 40 + [1] * 40)
    _, labels = kmeans.kmeans(x, k, seed=0, device="cpu")
    assert rand_index(y, labels) > 0.95


# ------------------------------------------------------------------- DTCR
B, L, HIDDEN = 12, 32, 8


def _dtcr_case(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L)).astype(np.float32)
    jcfg = jdtcr.DTCRConfig(hidden=HIDDEN, n_clusters=3)
    tcfg = dtcr.DTCRConfig(hidden=HIDDEN, n_clusters=3)
    jp = jdtcr.init_params(jax.random.key(seed + 1), jcfg)
    tp = dtcr.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    xj = jnp.asarray(x)
    xj = (xj - xj.mean(axis=1, keepdims=True)) / (xj.std(axis=1, keepdims=True) + 1e-6)
    xt = dtcr.normalize(torch.from_numpy(x))
    centers = rng.normal(size=(3, 2 * HIDDEN)).astype(np.float32)
    return jcfg, tcfg, jp, tp, xj, xt, centers


def _jax_loss(p, x, centers, cfg, key):
    """The loss closure of the JAX package's ``fit_predict``, verbatim."""
    b, length = x.shape
    rep = jdtcr.encode(p, x)
    recon = jdtcr.decode(p, rep, length)
    l_rec = ((recon - x) ** 2).mean()
    l_km = jdtcr._soft_kmeans_loss(rep, centers)
    fakes = jdtcr._make_fakes(key, x)
    rep_f = jdtcr.encode(p, fakes)
    logits = jnp.concatenate([rep, rep_f]) @ p["w_cls"] + p["b_cls"]
    labels = jnp.concatenate([jnp.zeros((b,), jnp.int32), jnp.ones((b,), jnp.int32)])
    l_fake = -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(2 * b), labels])
    return l_rec + cfg.lam_kmeans * l_km + cfg.lam_fake * l_fake


# jitted, with the config static: one trace for every step
_jax_grad = jax.jit(jax.grad(_jax_loss), static_argnums=3)


def _jax_adam(p, m, v, g, t, lr):
    """The Adam of the JAX package's ``fit_predict`` step, verbatim."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = jax.tree.map(lambda a, gg: b1 * a + (1 - b1) * gg, m, g)
    v = jax.tree.map(lambda a, gg: b2 * a + (1 - b2) * gg**2, v, g)
    mhat = jax.tree.map(lambda a: a / (1 - b1**t), m)
    vhat = jax.tree.map(lambda a: a / (1 - b2**t), v)
    p = jax.tree.map(lambda pp, a, c: pp - lr * a / (jnp.sqrt(c) + eps), p, mhat, vhat)
    return p, m, v


def _max_rel(t_tree, j_tree) -> float:
    t = np.concatenate([a.ravel() for a in jax.tree.leaves(dtcr.params_to_numpy(t_tree))])
    j = np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(j_tree)])
    return float(np.abs(t - j).max() / np.abs(j).max())


def test_dtcr_normalize_uses_the_population_std():
    *_, xj, xt, _ = _dtcr_case()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-5)


def test_dtcr_forward_matches_jax():
    jcfg, tcfg, jp, tp, xj, xt, centers = _dtcr_case()
    jr = jdtcr.encode(jp, xj)
    tr = dtcr.encode(tp, xt)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        dtcr.decode(tp, tr, L).numpy(), np.asarray(jdtcr.decode(jp, jr, L)),
        rtol=0, atol=1e-5)
    c = jnp.asarray(centers)
    jl = _jax_loss(jp, xj, c, jcfg, jax.random.key(3))
    tl = dtcr.loss_fn(tp, xt, torch.from_numpy(centers), tcfg)
    assert abs(float(tl) - float(jl)) < 1e-5, (float(tl), float(jl))


def test_dtcr_fakes_equal_the_series_in_both_packages():
    *_, xj, xt, _ = _dtcr_case()
    np.testing.assert_array_equal(
        np.asarray(jdtcr._make_fakes(jax.random.key(3), xj)), np.asarray(xj))
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(dtcr._make_fakes(gen, xt), xt)


def test_dtcr_gradients_match_jax():
    jcfg, tcfg, jp, tp, xj, xt, centers = _dtcr_case()
    jg = _jax_grad(jp, xj, jnp.asarray(centers), jcfg, jax.random.key(3))
    loss, tg = dtcr.value_and_grad(tp, xt, torch.from_numpy(centers), tcfg)
    assert set(tg) == set(jg) and set(tg["dec"]) == set(jg["dec"])
    assert _max_rel(tg, jg) < 1e-4


def test_dtcr_five_adam_steps_match_jax():
    jcfg, tcfg, jp, tp, xj, xt, centers = _dtcr_case()
    jc, tc = jnp.asarray(centers), torch.from_numpy(centers)
    jm = jax.tree.map(jnp.zeros_like, jp)
    jv = jax.tree.map(jnp.zeros_like, jp)
    tm = dtcr._tree_map(torch.zeros_like, tp)
    tv = dtcr._tree_map(torch.zeros_like, tp)
    key = jax.random.key(0)
    for t in range(1, 6):
        key, k = jax.random.split(key)
        jg = _jax_grad(jp, xj, jc, jcfg, k)
        jp, jm, jv = _jax_adam(jp, jm, jv, jg, jnp.float32(t), jcfg.lr)
        _, tg = dtcr.value_and_grad(tp, xt, tc, tcfg)
        tp, tm, tv = dtcr.adam_step(tp, tm, tv, tg, t, tcfg.lr)
    assert _max_rel(tp, jp) < 1e-4
    assert _max_rel(tm, jm) < 1e-4


def _easy_data():
    """The data of the JAX package's DTCR test (tests/test_clustering.py)."""
    rng = np.random.default_rng(1)
    t = np.linspace(0, 1, 32)
    xs = [np.sin(2 * np.pi * 3 * t) + rng.normal(0, 0.2, 32) for _ in range(20)]
    xs += [np.sign(np.sin(2 * np.pi * 1 * t)) + rng.normal(0, 0.2, 32)
           for _ in range(20)]
    return np.stack(xs), np.array([0] * 20 + [1] * 20)


def test_dtcr_fit_predict_matches_jax_with_carried_parameters():
    x, _ = _easy_data()
    jcfg = jdtcr.DTCRConfig(n_clusters=2, steps=40, hidden=16)
    tcfg = dtcr.DTCRConfig(n_clusters=2, steps=40, hidden=16)
    # the parameters the JAX package's fit_predict draws: the second key
    # of split(key(seed))
    _, kp = jax.random.split(jax.random.key(jcfg.seed))
    jp = jax.tree.map(np.asarray, jdtcr.init_params(kp, jcfg))
    j_labels = jdtcr.fit_predict(x, jcfg)
    t_labels = dtcr.fit_predict(x, tcfg, device="cpu",
                                params=dtcr.params_from_jax(jp, "cpu"))
    np.testing.assert_array_equal(t_labels, np.asarray(j_labels))


def test_dtcr_runs_and_beats_chance_on_easy_data():
    x, y = _easy_data()
    labels = dtcr.fit_predict(x, dtcr.DTCRConfig(n_clusters=2, steps=40, hidden=16),
                              device="cpu")
    assert rand_index(y, labels) > 0.55


def test_dtcr_config_and_initial_state_match_jax():
    import dataclasses

    assert dataclasses.asdict(dtcr.DTCRConfig()) == dataclasses.asdict(jdtcr.DTCRConfig())
    cfg = dtcr.DTCRConfig(hidden=HIDDEN, n_clusters=3, seed=4)
    tp = dtcr.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    jp = jdtcr.init_params(jax.random.key(0), jdtcr.DTCRConfig(hidden=HIDDEN))
    same_shapes = jax.tree.map(lambda a, b: tuple(a.shape) == tuple(b.shape),
                               dtcr.params_to_numpy(tp), jax.tree.map(np.asarray, jp))
    assert all(jax.tree.leaves(same_shapes))
    want = np.random.default_rng(4).normal(size=(3, 2 * HIDDEN)).astype(np.float32)
    np.testing.assert_array_equal(dtcr.initial_centers(cfg, "cpu").numpy(), want)
