"""Port parity, part 15: the optimizers (``distributed/optimizer.py``).

The JAX package's optimizers and the port's take the same injected
parameter and gradient trees, in the JAX package's layout (the granite,
kimi and mamba2 smoke configs' trees, layers stacked on a leading axis),
made from numpy with a seed.  The JAX side runs op by op (not under
``jax.jit``): XLA's fused CPU code contracts multiply-adds into FMAs,
which moves EF's int8 codes and every moment by an ulp, so the eager ops
are the reference.  Every new parameter and f32 state leaf must equal
JAX's within rtol = atol = 1e-6, for each update from the same inputs
(JAX's parameters and state of the step before injected into the port)
and, for AdamW, along the port's own three updates too.  Adafactor's bf16
first moment is bit equal on all but a handful of entries per leaf:
XLA's CPU ``rsqrt`` is not IEEE-rounded (it differs from any f32
``1/sqrt`` in about a third of its results) and its reductions sum in
another order, so an f32 value within an ulp of a bf16 rounding tie may
round the other way.  Those entries must be within one bf16 step of
JAX's plus the f32 tolerance (where the moment cancels to near zero, an
ulp of its operands spans several bf16 steps of the result), and the
parameters there within ``lr`` times the moments' gap.

The stacking tests hold the port to the JAX package's per-LEAF rules on
stacked leaves and show that a per-layer optimizer fails them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.distributed import optimizer as jopt
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.distributed import optimizer as topt
from repro_torch.models import transformer as T

ARCHS = ("granite-3-8b", "kimi-k2-1t-a32b", "mamba2-370m")
KINDS = ("adamw", "adamw_ef", "adafactor")
LR = 1e-2


def _params(arch_id) -> dict:
    cfg = jconfigs.get_arch(arch_id, smoke=True)
    return jax.tree.map(np.asarray, jT.init_params(jax.random.key(0), cfg))


def _grads(params, rng, scale=0.05) -> dict:
    return jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32), params)


def _pair(kind):
    """(JAX optimizer, the port's), weight decay 0.1 for AdamW."""
    js = jopt.Schedule(peak_lr=LR, warmup_steps=2, total_steps=10)
    ts = topt.Schedule(peak_lr=LR, warmup_steps=2, total_steps=10)
    if kind == "adafactor":
        return jopt.make_optimizer("adafactor", js), topt.make_optimizer("adafactor", ts)
    c = kind == "adamw_ef"
    j, t = jopt.make_optimizer("adamw", js, compress=c), topt.make_optimizer("adamw", ts, compress=c)
    assert j.weight_decay == t.weight_decay == 0.1
    return j, t


def _to_torch(tree):
    """numpy or JAX leaves -> tensors (bf16 through its bit patterns)."""
    def one(x):
        x = np.asarray(x)
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return topt.tree_map(one, tree)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _paths(tree):
    return [(jax.tree_util.keystr(p), x) for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def _check_step(jp, js, tp, ts, lr):
    """Every parameter and state leaf against JAX's (see the docstring)."""
    t_state = dict(zip([k for k, _ in _paths(js)], topt.tree_leaves(ts)))
    m_gap = {}
    for name, want in _paths(js):
        got = _np(t_state[name])
        want = _np(want)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if got.dtype == np.int16:  # Adafactor's bf16 m, as bit patterns
            differ = got != want
            assert differ.mean() <= 1e-3, (name, int(differ.sum()))
            g32 = got.view(jnp.bfloat16).astype(np.float32)
            w32 = want.view(jnp.bfloat16).astype(np.float32)
            gap = np.abs(g32 - w32)
            assert np.all(gap <= 2.0**-7 * np.abs(w32) + 1e-6), name
            m_gap[name[len("['m']"):]] = gap
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)
    for (name, want), got in zip(_paths(jp), topt.tree_leaves(tp)):
        got, want = got.numpy(), np.asarray(want)
        slack = lr * m_gap[name] if name in m_gap else 0.0
        assert np.all(np.abs(got - want) <= 1e-6 + 1e-6 * np.abs(want) + slack), name


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch_id", ARCHS)
def test_three_updates_equal_jax(arch_id, kind):
    params = _params(arch_id)
    rng = np.random.default_rng(11)
    jo, to = _pair(kind)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for k, v in _to_torch(js).items():  # the init states agree
        assert all(torch.equal(a, b) for a, b in zip(topt.tree_leaves(v),
                                                     topt.tree_leaves(ts[k])))
    for step in range(1, 4):
        g = _grads(params, rng)
        lr = float(jo.schedule(jnp.asarray(step)))
        # this update from JAX's inputs
        one_p, one_s = to.update(_to_torch(jp), _to_torch(g), _to_torch(js))
        jp, js = jo.update(jp, jax.tree.map(jnp.asarray, g), js)
        assert int(one_s["step"]) == int(js["step"]) == step
        _check_step(jp, js, one_p, one_s, lr)
        # the port's own chain of updates
        tp, ts = to.update(tp, _to_torch(g), ts)
        if kind != "adafactor":
            _check_step(jp, js, tp, ts, lr)


def test_state_dtypes_are_jax_dtypes():
    params = _to_torch(_params("granite-3-8b"))
    sched = topt.Schedule()
    a = topt.make_optimizer("adamw", sched, compress=True).init(params)
    assert a["step"].dtype == torch.int32 and a["step"].shape == ()
    for leaf in topt.tree_leaves({k: a[k] for k in ("m", "v", "ef")}):
        assert leaf.dtype == torch.float32
    f = topt.make_optimizer("adafactor", sched).init(params)
    assert f["step"].dtype == torch.int32
    assert {x.dtype for x in topt.tree_leaves(f["m"])} == {torch.bfloat16}
    assert {x.dtype for x in topt.tree_leaves({"vr": f["vr"], "vc": f["vc"]})} == {torch.float32}
    # the stacked gammas [L, D] are factored over (L, D)
    L, D = params["blocks"]["norm1"].shape
    assert f["vr"]["blocks"]["norm1"].shape == (L,)
    assert f["vc"]["blocks"]["norm1"].shape == (D,)
    assert f["vc"]["final_norm"].shape == (1,)


def test_schedule_equals_jax():
    for kw in (dict(), dict(peak_lr=2e-3, warmup_steps=3, total_steps=30),
               dict(peak_lr=1.0, warmup_steps=0, total_steps=1, min_ratio=0.0)):
        js, ts = jopt.Schedule(**kw), topt.Schedule(**kw)
        for step in (0, 1, 2, 3, 50, 99, 100, 101, 5000, 10000, 20000):
            want = np.asarray(js(jnp.asarray(step, jnp.int32)))
            got = ts(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("scale", [0.001, 0.05, 3.0])
def test_clip_by_global_norm_equals_jax(scale):
    """Three trees, below and above the clip norm; a bf16 leaf keeps its
    dtype."""
    g = _grads(_params("kimi-k2-1t-a32b"), np.random.default_rng(5), scale)
    jg = jax.tree.map(jnp.asarray, g)
    jg["embed"] = jg["embed"].astype(jnp.bfloat16)
    tg = _to_torch(g)
    tg["embed"] = tg["embed"].to(torch.bfloat16)
    jc, jn = jopt.clip_by_global_norm(jg, 1.0)
    tc, tn = topt.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    assert (float(tn) > 1.0) == (scale > 0.001)
    for (name, want), got in zip(_paths(jc), topt.tree_leaves(tc)):
        if got.dtype == torch.bfloat16:
            # one rounding of f32 values equal within an ulp
            assert np.abs(_np(got).astype(np.int32) - _np(want).astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-9, err_msg=name)


# ------------------------------------------------------------- stacking
def _per_layer(tree):
    """What a naive port would hand the optimizer: every stacked leaf
    split into one leaf per layer."""
    def split(sub):
        if isinstance(sub, dict):
            return {k: split(v) for k, v in sub.items()}
        return {str(i): sub[i] for i in range(sub.shape[0])}
    return {k: split(v) if k in ("blocks", "enc_blocks", "cross_blocks") else v
            for k, v in tree.items()}


def _stack_back(tree):
    def join(sub):
        if isinstance(next(iter(sub.values())), dict):
            return {k: join(v) for k, v in sub.items()}
        return torch.stack([sub[str(i)] for i in range(len(sub))])
    return {k: {n: join(v) for n, v in tree[k].items()}
            if k in ("blocks", "enc_blocks", "cross_blocks") else v for k, v in tree.items()}


def _spiky(x):
    """Layer 1 of a stacked leaf: small noise and one spike, so its max
    (EF's scale) and its factored update's RMS (Adafactor's clip, > 1)
    are far from layer 0's."""
    x = x.copy()
    x[1] *= 0.01
    x[1].flat[0] = 100.0
    return x


def _stacking_case(kind):
    """granite's tree with ``_spiky`` stacked leaves, one step in JAX and
    in the port, the port fed the stacked tree and a per-layer one."""
    params = _params("granite-3-8b")
    g = _grads(params, np.random.default_rng(7), scale=1.0)
    g["blocks"] = jax.tree.map(_spiky, g["blocks"])
    jo, to = _pair(kind)
    jp, _ = jo.update(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, g),
                      jo.init(jax.tree.map(jnp.asarray, params)))
    tp, tparams = _to_torch(params), _to_torch(params)
    stacked, _ = to.update(tp, _to_torch(g), to.init(tp))
    lp = _per_layer(tparams)
    per_layer, _ = to.update(lp, _per_layer(_to_torch(g)), to.init(lp))
    return params, jax.tree.map(np.asarray, jp), stacked, _stack_back(per_layer)


def _close(a, b) -> bool:
    return np.allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_adamw_decays_the_stacked_norm_gammas():
    """AdamW decays leaves of ndim >= 2: the stacked gammas [L, D] are
    decayed (with zero gradients, by exactly lr * wd), as in JAX; a
    per-layer gamma [D] would not be."""
    params = _params("granite-3-8b")
    zero = jax.tree.map(np.zeros_like, params)
    jo, to = _pair("adamw")
    jp, _ = jo.update(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, zero),
                      jo.init(jax.tree.map(jnp.asarray, params)))
    model = T.params_from_jax(params, configs.get_arch("granite-3-8b", smoke=True), "cpu")
    tree = T.param_tree(model)
    assert tree["blocks"]["norm1"].shape == params["blocks"]["norm1"].shape
    new, _ = to.update(tree, _to_torch(zero), to.init(tree))
    lr = float(to.schedule(torch.tensor(1)))
    for name in ("norm1", "norm2"):
        want = np.asarray(jp["blocks"][name])
        np.testing.assert_allclose(new["blocks"][name].numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(want, params["blocks"][name] * (1 - lr * 0.1), rtol=1e-6)
    assert _close(new["final_norm"], params["final_norm"])  # [D]: not decayed
    lp = _per_layer(_to_torch(params))
    naive, _ = to.update(lp, _per_layer(_to_torch(zero)), to.init(lp))
    assert _close(naive["blocks"]["norm1"]["0"], params["blocks"]["norm1"][0])


@pytest.mark.parametrize("kind", ["adamw_ef", "adafactor"])
def test_per_leaf_statistics_span_the_stacked_leaf(kind):
    """EF's scale and Adafactor's RMS clip (and its factoring of the
    gammas) are one per stacked leaf: the port fed the stacked tree
    equals JAX; fed per-layer leaves it does not."""
    params, want, stacked, naive = _stacking_case(kind)
    for name in ("norm1", "attn", "mlp"):
        for (path, w), s, n in zip(_paths(want["blocks"][name]),
                                   topt.tree_leaves(stacked["blocks"][name]),
                                   topt.tree_leaves(naive["blocks"][name])):
            np.testing.assert_allclose(s.numpy(), w, rtol=1e-6, atol=1e-6,
                                       err_msg=name + path)
            assert not _close(n.numpy(), w), name + path


def test_ef_scale_is_one_per_stacked_leaf():
    """Layer 1's quantized gradients sit on the grid of the STACKED
    leaf's scale (its max is layer 1's)."""
    g = _grads(_params("granite-3-8b"), np.random.default_rng(8), scale=1.0)
    w = g["blocks"]["mlp"]["w_up"] * np.array([100.0, 1.0], np.float32)[:, None, None]
    gq, res = topt.ErrorFeedbackInt8().apply({"w": torch.from_numpy(w)},
                                             {"w": torch.zeros(w.shape)})
    jq, jres = jopt.ErrorFeedbackInt8().apply({"w": jnp.asarray(w)}, {"w": jnp.zeros(w.shape)})
    np.testing.assert_array_equal(gq["w"].numpy(), np.asarray(jq["w"]))
    np.testing.assert_array_equal(res["w"].numpy(), np.asarray(jres["w"]))
    scale = np.float32(np.abs(w).max()) / np.float32(127.0)
    codes = gq["w"][1].numpy() / scale
    np.testing.assert_allclose(codes, np.round(codes), atol=1e-3)
    assert np.abs(np.round(codes)).max() <= 2  # layer 1 is ~1/100 of the scale


# ------------------------------------ ports of tests/test_distributed.py
def test_adamw_and_adafactor_reduce_loss_quadratic():
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32))

    def loss(p):
        return torch.mean((p["w"] - target) ** 2)

    for opt in (topt.AdamW(topt.Schedule(peak_lr=0.05, warmup_steps=1, total_steps=100),
                           weight_decay=0.0),
                topt.Adafactor(topt.Schedule(peak_lr=0.5, warmup_steps=1, total_steps=100))):
        params = {"w": torch.zeros((8, 8))}
        state = opt.init(params)
        l0 = float(loss(params))
        for _ in range(40):
            w = params["w"].clone().requires_grad_(True)
            (g,) = torch.autograd.grad(loss({"w": w}), [w])
            params, state = opt.update(params, {"w": g}, state)
        assert float(loss(params)) < 0.5 * l0, type(opt).__name__


def test_adafactor_state_is_factored():
    opt = topt.Adafactor(topt.Schedule())
    st = opt.init({"w": torch.zeros((16, 32)), "b": torch.zeros((32,))})
    assert st["vr"]["w"].shape == (16,)
    assert st["vc"]["w"].shape == (32,)
    assert st["m"]["w"].dtype == torch.bfloat16


def test_error_feedback_compression_converges():
    target = torch.from_numpy(np.random.default_rng(1).normal(size=(16, 16)).astype(np.float32))

    def run(compress):
        opt = topt.make_optimizer(
            "adamw", topt.Schedule(peak_lr=0.05, warmup_steps=1, total_steps=200),
            compress=compress,
        )
        opt.weight_decay = 0.0
        params = {"w": torch.zeros((16, 16))}
        state = opt.init(params)
        for _ in range(60):
            g = 2 * (params["w"] - target) / target.numel()
            params, state = opt.update(params, {"w": g}, state)
        return float(torch.mean((params["w"] - target) ** 2))

    plain, comp = run(False), run(True)
    assert comp < 2.0 * plain + 1e-3


def test_ef_quantization_residual_identity():
    ef = topt.ErrorFeedbackInt8()
    g = {"a": torch.from_numpy(np.random.default_rng(2).normal(size=(32,)).astype(np.float32))}
    gq, r2 = ef.apply(g, ef.init(g))
    np.testing.assert_allclose((gq["a"] + r2["a"]).numpy(), g["a"].numpy(), rtol=1e-6, atol=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd", topt.Schedule())
