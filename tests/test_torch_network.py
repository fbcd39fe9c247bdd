"""Port parity, part 6: multi-layer networks.

The JAX package and the port train the same networks from the same
numpy-seeded weights on the CPU (``network.fit_greedy`` per backend, and
``simulator.cluster_time_series_network`` end to end from weights carried
across with ``network.params_from_jax``) and must agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jnetwork
from repro.core import simulator as jsim
from repro.core.types import ColumnConfig as JColumn
from repro.core.types import LayerConfig as JLayer
from repro.core.types import NetworkConfig as JNetwork
from repro.core.types import NeuronConfig as JNeuron
from repro.core.types import STDPConfig as JSTDP
from repro_torch.core import network, simulator
from repro_torch.core.types import (
    ColumnConfig, LayerConfig, NetworkConfig, NeuronConfig, STDPConfig,
)

GRID = dict(mu_capture=1.0, mu_backoff=1.0, mu_search=1.0, stabilizer="none")


def _nets(layers, grid=True):
    """The same network in both packages: layers are (columns, p, q,
    t_max, threshold, connectivity)."""
    out = []
    for Col, Neu, Stdp, Lay, Net in ((ColumnConfig, NeuronConfig, STDPConfig,
                                      LayerConfig, NetworkConfig),
                                     (JColumn, JNeuron, JSTDP, JLayer, JNetwork)):
        stdp = Stdp(**GRID) if grid else Stdp()
        out.append(Net(layers=tuple(
            Lay(columns=c, connectivity=conn,
                column=Col(p=p, q=q, t_max=t, neuron=Neu(threshold=th), stdp=stdp))
            for c, p, q, t, th, conn in layers
        )))
    return out


TWO_LAYER = [(2, 8, 4, 16, 5.0, "full"), (1, 8, 2, 16, 4.0, "full")]


def _weights(net, seed=0, grid=True):
    rng = np.random.default_rng(seed)
    out = []
    for l in net.layers:
        shape = (l.columns, l.column.p, l.column.q)
        w = (rng.integers(0, 8, shape) if grid else rng.uniform(0, 7, shape))
        out.append({"w": w.astype(np.float32)})
    return out


@pytest.mark.parametrize("mode", ["pallas", "cycle", "event", "auto"])
def test_fit_greedy_matches_jax_on_integer_weights(mode):
    net, jnet = _nets(TWO_LAYER)
    w0 = _weights(net)
    x = np.random.default_rng(1).integers(0, 20, (10, 8)).astype(np.int32)
    jp = jnetwork.fit_greedy([{"w": jnp.asarray(p["w"])} for p in w0],
                             jnp.asarray(x), jnet, epochs=3, mode=mode)
    tp = network.fit_greedy(network.params_from_jax(w0, device="cpu"),
                            torch.from_numpy(x), net, epochs=3, mode=mode)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a["w"].numpy(), np.asarray(b["w"]))
    np.testing.assert_array_equal(
        network.apply(tp, torch.from_numpy(x), net, "cycle").numpy(),
        np.asarray(jnetwork.apply(jp, jnp.asarray(x), jnet, "cycle")))
    np.testing.assert_array_equal(
        network.cluster_assignments(tp, torch.from_numpy(x), net, mode).numpy(),
        np.asarray(jnetwork.cluster_assignments(jp, jnp.asarray(x), jnet, mode)))


def test_fit_greedy_backends_agree_inside_the_port():
    """On integer grids the fused layers equal the cycle and event
    solvers bit for bit, as in the JAX package."""
    net, _ = _nets(TWO_LAYER)
    x = torch.from_numpy(
        np.random.default_rng(2).integers(0, 20, (12, 8)).astype(np.int32))
    outs = {}
    for mode in ("pallas", "cycle", "event"):
        p = network.fit_greedy(network.params_from_jax(_weights(net, 3), "cpu"),
                               x, net, epochs=2, mode=mode)
        outs[mode] = [lp["w"] for lp in p]
    for mode in ("cycle", "event"):
        for a, b in zip(outs["pallas"], outs[mode]):
            assert torch.equal(a, b), mode


@pytest.mark.parametrize("grid", [True, False])
def test_cluster_time_series_network_matches_jax(grid):
    layers = [(2, 12, 4, 24, 9.0, "full"), (1, 8, 3, 24, 5.0, "full")]
    net, jnet = _nets(layers, grid=grid)
    rng = np.random.default_rng(4)
    x, y = rng.normal(size=(18, 12)), rng.integers(0, 3, 18)
    w0 = _weights(net, seed=5, grid=grid)
    # the JAX front end draws its own weights: train JAX's with ours by
    # running its loop on them, as its cluster_time_series_network does
    volleys = jsim._encode_width(jnp.asarray(x), 24, 12, "latency")
    jp = jnetwork.fit_greedy([{"w": jnp.asarray(p["w"])} for p in w0], volleys,
                             jnet, epochs=3, mode="auto")
    jasg = np.asarray(jnetwork.cluster_assignments(jp, volleys, jnet, "auto"))
    from repro.clustering.metrics import rand_index as jrand

    res = simulator.cluster_time_series_network(
        x, y, net, epochs=3, device="cpu",
        params=network.params_from_jax(w0, device="cpu"))
    np.testing.assert_array_equal(res.assignments, jasg)
    assert res.rand_index == float(jrand(y, jasg))
    for a, b in zip(res.params["layers"], jp):
        np.testing.assert_array_equal(a["w"].numpy(), np.asarray(b["w"]))
    assert res.lowering == "reference" and res.mode == "auto"
    assert [m["v_blk"] for m in res.plan["layers"]] == [4, 2]  # max(2, 2 columns)


def test_cluster_time_series_network_jax_front_end_from_its_weights():
    """The JAX front end's own weights, carried across, give its result."""
    layers = [(2, 10, 3, 16, 7.0, "full"), (1, 6, 2, 16, 3.0, "full")]
    net, jnet = _nets(layers, grid=False)
    rng = np.random.default_rng(8)
    x, y = rng.normal(size=(15, 10)), rng.integers(0, 2, 15)
    jr = jsim.cluster_time_series_network(x, y, jnet, epochs=2, seed=3)
    import jax

    _, init_key = jax.random.split(jax.random.key(3))
    w0 = jnetwork.init_params(init_key, jnet, 10)
    tr = simulator.cluster_time_series_network(
        x, y, net, epochs=2, device="cpu",
        params=network.params_from_jax(w0, device="cpu"))
    np.testing.assert_array_equal(tr.assignments, jr.assignments)
    assert tr.rand_index == jr.rand_index
    for a, b in zip(tr.params["layers"], jr.params["layers"]):
        np.testing.assert_array_equal(a["w"].numpy(), np.asarray(b["w"]))


def test_tiled_connectivity_and_widths():
    layers = [(2, 4, 3, 16, 3.0, "tiled"), (1, 6, 2, 12, 3.0, "full")]
    net, jnet = _nets(layers)
    assert network.in_width(net) == jnetwork.in_width(jnet) == 8
    assert network.out_width(net) == jnetwork.out_width(jnet) == 2
    w0 = _weights(net, seed=6)
    x = np.random.default_rng(7).integers(0, 18, (9, 8)).astype(np.int32)
    jp = jnetwork.fit_greedy([{"w": jnp.asarray(p["w"])} for p in w0],
                             jnp.asarray(x), jnet, epochs=2, mode="pallas")
    tp = network.fit_greedy(network.params_from_jax(w0, "cpu"),
                            torch.from_numpy(x), net, epochs=2, mode="pallas")
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a["w"].numpy(), np.asarray(b["w"]))


def test_validate_and_init_params():
    net, _ = _nets(TWO_LAYER)
    with pytest.raises(ValueError, match="column.p"):
        network.validate(net, 9)
    grow, _ = _nets([(1, 8, 4, 16, 5.0, "full"), (1, 4, 2, 24, 4.0, "full")])
    with pytest.raises(ValueError, match="sentinel"):
        network.validate(grow, 8)
    g = torch.Generator().manual_seed(0)
    p = network.init_params(net, 8, g, "cpu")
    assert [tuple(lp["w"].shape) for lp in p] == [(2, 8, 4), (1, 8, 2)]
    assert all(((lp["w"] >= 0) & (lp["w"] <= 7)).all() for lp in p)
    with pytest.raises(ValueError, match="layer 1"):
        network.init_params(net, 8, device="cpu",
                            params=[{"w": np.zeros((2, 8, 4))}, {"w": np.zeros((2, 8, 2))}])


def test_non_fusable_layers_train_on_the_solvers():
    net, _ = _nets(TWO_LAYER)
    lif = NetworkConfig(layers=(
        LayerConfig(columns=2, column=ColumnConfig(
            p=8, q=4, t_max=16, neuron=NeuronConfig(response="lif", threshold=5.0),
            stdp=STDPConfig(**GRID))),
        net.layers[1],
    ))
    x = torch.from_numpy(
        np.random.default_rng(3).integers(0, 20, (6, 8)).astype(np.int32))
    sink = []
    p = network.fit_greedy(network.params_from_jax(_weights(net), "cpu"), x, lif,
                           epochs=1, mode="auto", plan_sink=sink)
    assert len(p) == 2 and len(sink) == 1  # only the RNL layer is fused
    with pytest.raises(ValueError):
        network.fit_greedy(network.params_from_jax(_weights(net), "cpu"), x, lif,
                           epochs=1, mode="pallas")
    rand = NetworkConfig(layers=(LayerConfig(columns=1, column=ColumnConfig(
        p=8, q=2, t_max=16, stdp=STDPConfig(mode="stochastic"))),))
    with pytest.raises(ValueError, match="Generator"):
        network.fit_greedy([{"w": torch.zeros(1, 8, 2)}], x, rand, epochs=1)


def test_network_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net, _ = _nets(TWO_LAYER)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.cluster_time_series_network(np.zeros((3, 8)), None, net)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        network.params_from_jax([{"w": np.zeros((2, 8, 4))}])
