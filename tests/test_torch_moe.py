"""Port parity, part 15: the MoE FFN (``models/moe.py``).

The JAX package and the port run the same numpy-seeded inputs and weights
on the CPU: the router's top-k ids equal (ties too: the lower expert id
first, as ``jax.lax.top_k`` orders them), its probabilities and aux loss
within 1e-6; ``moe_apply`` (gathered and ragged) and ``moe_reference``
within 1e-5 of JAX's at capacity factor 2.0, with the same assignments
dropped.  Then the decode quirk of the reference, kept: at decode T = B
tokens, so ``cap_e = max(1, round(T k / E cf))`` is 1 for an olmoe-sized
router at B 2 and assignments that collide on an expert are dropped;
both packages drop the same ones.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _cfgs(arch_id="olmoe-1b-7b", **kw):
    return (dataclasses.replace(configs.get_arch(arch_id, smoke=True), **kw),
            dataclasses.replace(jconfigs.get_arch(arch_id, smoke=True), **kw))


def _params(cfg, seed):
    """Numpy expert weights in the JAX layout."""
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": (rng.normal(size=(D, E)) / np.sqrt(D)).astype(np.float32),
        "w_gate": (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32),
        "w_up": (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32),
        "w_down": (rng.normal(size=(E, F, D)) / np.sqrt(F)).astype(np.float32),
    }


def _both(p):
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("top_k", [1, 2, 8])
def test_router_topk_equals_jax_with_ties(top_k):
    """A router column duplicated into another gives every token two equal
    logits; both packages put the lower expert id first."""
    rng = np.random.default_rng(top_k)
    D, E, T = 32, 16, 40
    router = rng.normal(size=(D, E)).astype(np.float32)
    router[:, 9] = router[:, 2]  # experts 2 and 9 tie on every token
    router[:, 5] = router[:, 12]
    x = rng.normal(size=(T, D)).astype(np.float32)
    probs, ids, aux = moe.router_topk(torch.from_numpy(x), torch.from_numpy(router), top_k)
    jprobs, jids, jaux = jmoe.router_topk(jnp.asarray(x), jnp.asarray(router), top_k)
    assert ids.shape == (T, top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-6)
    assert abs(float(aux) - float(jaux)) < 1e-6
    if top_k >= 2:  # the tie is met: a tied pair sits side by side, low id first
        logits = x @ router
        both = [(t, j) for t in range(T) for j in range(top_k - 1)
                if {int(ids[t, j]), int(ids[t, j + 1])} in ({2, 9}, {5, 12})]
        assert both, "no tied pair among the top-k"
        assert all(int(ids[t, j]) < int(ids[t, j + 1]) for t, j in both)
        assert np.all(np.diff(np.take_along_axis(logits, ids.numpy(), 1), axis=1) <= 0)


@pytest.mark.parametrize("impl", ["gathered", "ragged"])
@pytest.mark.parametrize("arch_id", ["olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_moe_apply_equals_jax_at_cf2(impl, arch_id):
    """Feature 0 of every token is 1 and the router favours experts 0 and
    1 on it, so those two overflow their capacity (the gathered path drops
    about half their assignments; at one shard the ragged path's capacity
    is T k and drops none)."""
    cfg, jcfg = _cfgs(arch_id, moe_capacity_factor=2.0, moe_impl=impl)
    p = _params(cfg, 1)
    p["router"][0, :2] = 3.0
    tp, jp = _both(p)
    x = np.random.default_rng(2).normal(size=(3, 21, cfg.d_model)).astype(np.float32)
    x[..., 0] = 1.0
    got = moe.moe_apply(torch.from_numpy(x), tp, cfg)
    want = jmoe.moe_apply(jnp.asarray(x), jp, jcfg, mesh=None)
    assert got.shape == x.shape
    assert _rel_err(got.numpy(), want) < 1e-5
    ref = moe.moe_reference(torch.from_numpy(x), tp, cfg)
    jref = jmoe.moe_reference(jnp.asarray(x), jp, jcfg)
    assert _rel_err(ref.numpy(), jref) < 1e-5
    # the same tokens lose an assignment in both packages
    lost = np.abs(got.numpy() - ref.numpy()).max(-1) > 1e-5 * np.abs(ref.numpy()).max()
    jlost = np.abs(np.asarray(want) - np.asarray(jref)).max(-1) > 1e-5 * np.abs(
        np.asarray(jref)).max()
    np.testing.assert_array_equal(lost, jlost)
    assert lost.any() == (impl == "gathered")


def test_gathered_drops_are_the_reference_order():
    """``capacity_keep`` against a numpy recount: an assignment is dropped
    exactly when its expert already holds cap_e assignments earlier in
    flat (token, slot) order; at cf 1.0 some are."""
    cfg, _ = _cfgs(moe_capacity_factor=1.0)
    tp, _ = _both(_params(cfg, 3))
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(64, cfg.d_model)).astype(np.float32))
    _, ids, _ = moe.router_topk(x, tp["router"], cfg.top_k)
    flat = ids.reshape(-1)
    cap = moe.expert_capacity(64, cfg)
    keep, _ = moe.capacity_keep(flat, cfg.n_experts, cap)
    seen = np.zeros(cfg.n_experts, int)
    want = []
    for e in flat.tolist():
        want.append(seen[e] < cap)
        seen[e] += 1
    np.testing.assert_array_equal(keep.numpy(), np.array(want))
    assert 0 < (~keep).sum() < len(flat)


@pytest.mark.parametrize("T,k,E,cf,want", [
    (2, 8, 64, 2.0, 1),      # olmoe decode at B 2: round(0.5) = 0 -> 1
    (4, 8, 64, 2.0, 1),      # B 4: round(1.0) = 1
    (6, 8, 64, 2.0, 2),      # round(1.5) = 2 (half to even)
    (10, 8, 64, 2.0, 2),     # round(2.5) = 2 (half to even)
    (8192, 8, 384, 2.0, 341),  # kimi prefill, B 4 x 2048
])
def test_capacity_uses_python_round(T, k, E, cf, want):
    cfg, jcfg = _cfgs(n_experts=E, top_k=k, moe_capacity_factor=cf)
    assert moe.expert_capacity(T, cfg) == want
    assert want == int(max(1, round(T * jcfg.top_k / jcfg.n_experts
                                    * jcfg.moe_capacity_factor)))


def test_moe_reference_is_dropless_and_matches_apply_at_high_capacity():
    """At cf 16 nothing is dropped: gathered, ragged and the reference agree
    (the JAX package's test_moe_paths_agree_with_reference, same bound)."""
    cfg, _ = _cfgs(moe_capacity_factor=16.0)
    tp, _ = _both(_params(cfg, 5))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32))
    ref = moe.moe_reference(x, tp, cfg)
    for impl in ("gathered", "ragged"):
        y = moe.moe_apply(x, tp, dataclasses.replace(cfg, moe_impl=impl))
        assert _rel_err(y.numpy(), ref.numpy()) < 1e-4, impl


def _marker_params(cfg):
    """Experts whose output marks them: feature 0 of every token is 1, each
    expert's gate and up read feature 0 alone (gate 30, up 1), and its
    down projection writes 1 into output column e.  So y[t, e] is the
    routing probability of (t, e) where that assignment was kept and 0
    where it was dropped.  The router reads the other features."""
    rng = np.random.default_rng(8)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    assert D >= E
    router = (rng.normal(size=(D, E)) / np.sqrt(D)).astype(np.float32)
    router[0] = 0.0  # logits ~N(0, 1): every routed probability is >= ~1e-3
    wg = np.zeros((E, D, F), np.float32)
    wu = np.zeros((E, D, F), np.float32)
    wd = np.zeros((E, F, D), np.float32)
    wg[:, 0, :] = 30.0
    wu[:, 0, :] = 1.0
    h = 30.0 / (1.0 + np.exp(-30.0))  # silu(30)
    for e in range(E):
        wd[e, :, e] = 1.0 / (h * F)
    return {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}


def test_moe_decode_drops_collisions_in_both_packages():
    """The MoE decode quirk, kept (ROADMAP section 3): olmoe's router (E 64,
    top-8) at cf 2.0 and batch 2 decodes T = 2 tokens, so cap_e =
    max(1, round(2 * 8 / 64 * 2)) = 1 and every expert the two tokens
    share loses the second token's assignment.  The drop counts, read
    from the outputs, are equal in both packages and to a numpy recount;
    the prefill of the same tokens as 16-token prompts drops fewer, so
    serving-against-forward is not a property of the reference for MoE
    at this width."""
    kw = dict(n_experts=64, top_k=8, moe_capacity_factor=2.0, d_model=64)
    cfg, jcfg = _cfgs(**kw)
    p = _marker_params(cfg)
    tp, jp = _both(p)
    rng = np.random.default_rng(9)

    def tokens(T):
        x = rng.normal(size=(T, cfg.d_model)).astype(np.float32)
        x[:, 0] = 1.0
        return x

    def drops(x):
        B = x.shape[0]
        got = moe.moe_apply(torch.from_numpy(x[:, None]), tp, cfg)[:, 0].numpy()
        want = np.asarray(jmoe.moe_apply(jnp.asarray(x[:, None]), jp, jcfg, mesh=None))[:, 0]
        probs, ids, _ = moe.router_topk(torch.from_numpy(x), tp["router"], cfg.top_k)
        routed = np.zeros((B, cfg.n_experts), bool)
        np.put_along_axis(routed, ids.numpy(), True, axis=1)
        n_port = int((routed & (np.abs(got[:, : cfg.n_experts]) < 1e-6)).sum())
        n_jax = int((routed & (np.abs(want[:, : cfg.n_experts]) < 1e-6)).sum())
        # numpy recount: the first token keeps all its 8; a later token
        # loses every expert an earlier one holds (cap_e 1)
        cap = moe.expert_capacity(B, cfg)
        held = np.zeros(cfg.n_experts, int)
        recount = 0
        for t in range(B):
            for e in ids[t].tolist():
                recount += held[e] >= cap
                held[e] += 1
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return n_port, n_jax, int(recount), cap

    rates = []
    for _ in range(20):
        n_port, n_jax, recount, cap = drops(tokens(2))
        assert cap == 1
        assert n_port == n_jax == recount
        rates.append(n_port)
    assert sum(rates) > 0  # collisions happen at decode
    n16 = drops(tokens(16))
    assert n16[0] == n16[1] == n16[2] and n16[3] == 4
    assert n16[0] / (16 * 8) < sum(rates) / (20 * 2 * 8)
