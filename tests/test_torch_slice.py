"""Port parity, part 4: the single-column main path as a whole.

series -> latency encode -> init -> online STDP fit -> cluster
assignments -> Rand index, through ``simulator.cluster_time_series`` of
both packages.  The initial weights are JAX's own (the key split that the
JAX simulator makes from ``seed``), carried across with
``column.params_from_jax``; assignments and Rand index must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tnn_columns import column_config as jcolumn_config
from repro.core import column as jcolumn
from repro.core import simulator as jsim
from repro.core.types import ColumnConfig as JColumn
from repro.core.types import NeuronConfig as JNeuron
from repro.core.types import STDPConfig as JSTDP
from repro.data import ucr as jucr
from repro_torch.configs.tnn_columns import column_config
from repro_torch.core import backend, column, simulator
from repro_torch.core.types import ColumnConfig, NeuronConfig, STDPConfig


def _jax_w0(cfg, seed=0):
    """The initial weights JAX's cluster_time_series draws for ``seed``."""
    _, init_key = jax.random.split(jax.random.key(seed))
    return np.asarray(jcolumn.init_params(init_key, cfg)["w"])


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_cluster_time_series_matches_jax_on_ecg200(mode):
    ds = jucr.load("ECG200")
    x, y = ds.x[:40], ds.y[:40]
    jcfg = jcolumn_config("ECG200")
    jcfg = jcfg.with_threshold(jsim.suggest_threshold(jcfg))
    cfg = column_config("ECG200")
    cfg = cfg.with_threshold(simulator.suggest_threshold(cfg))
    assert cfg.neuron.threshold == jcfg.neuron.threshold
    jr = jsim.cluster_time_series(x, y, jcfg, epochs=2, mode=mode, seed=0)
    params = column.params_from_jax({"w": _jax_w0(jcfg)}, device="cpu")
    tr = simulator.cluster_time_series(x, y, cfg, epochs=2, mode=mode,
                                       device="cpu", params=params)
    np.testing.assert_array_equal(tr.assignments, jr.assignments)
    assert tr.rand_index == jr.rand_index
    assert len(np.unique(tr.assignments)) > 1  # a real clustering
    assert tr.lowering == "reference" and jr.lowering == "reference"
    np.testing.assert_allclose(column.params_to_numpy(tr.params)["w"],
                               np.asarray(jr.params["w"]), rtol=1e-6, atol=1e-6)


def test_cluster_time_series_own_weights_are_seeded():
    ds = jucr.load("ECG200")
    cfg = column_config("ECG200")
    a = simulator.cluster_time_series(ds.x[:20], ds.y[:20], cfg, epochs=1,
                                      device="cpu", seed=3)
    b = simulator.cluster_time_series(ds.x[:20], ds.y[:20], cfg, epochs=1,
                                      device="cpu", seed=3)
    np.testing.assert_array_equal(a.assignments, b.assignments)
    assert torch.equal(a.params["w"], b.params["w"])
    w0 = column.init_params(cfg, torch.Generator().manual_seed(3), "cpu")["w"]
    assert 0 <= w0.min() and w0.max() <= 7 and w0.shape == (96, 2)
    assert np.isnan(simulator.cluster_time_series(
        ds.x[:5], None, cfg, epochs=1, device="cpu").rand_index)


def _small(seed=1):
    kw = dict(p=12, q=3, t_max=16)
    jcfg = JColumn(neuron=JNeuron(threshold=12.0), stdp=JSTDP(), **kw)
    cfg = ColumnConfig(neuron=NeuronConfig(threshold=12.0), stdp=STDPConfig(), **kw)
    rng = np.random.default_rng(seed)
    w0 = rng.uniform(0, 7, (12, 3)).astype(np.float32)
    x = rng.integers(0, 18, (2, 4, 12)).astype(np.int32)  # a [2, 4] batch
    return jcfg, cfg, w0, x


@pytest.mark.parametrize("mode", ["auto", "event", "cycle", "pallas"])
def test_apply_and_cluster_assignments_match_jax(mode):
    jcfg, cfg, w0, x = _small()
    jy, jwin = jcolumn.apply({"w": jnp.asarray(w0)}, jnp.asarray(x), jcfg, mode)
    ty, twin = column.apply({"w": torch.from_numpy(w0)}, torch.from_numpy(x), cfg, mode)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
    ja = jcolumn.cluster_assignments({"w": jnp.asarray(w0)}, jnp.asarray(x[0]), jcfg, mode)
    ta = column.cluster_assignments({"w": torch.from_numpy(w0)}, torch.from_numpy(x[0]),
                                    cfg, mode)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("update", ["online", "batch"])
def test_train_step_matches_jax(update):
    jcfg, cfg, w0, x = _small(seed=4)
    jp, jy = jcolumn.train_step({"w": jnp.asarray(w0)}, jnp.asarray(x), jcfg,
                                update=update)
    tp, ty = column.train_step({"w": torch.from_numpy(w0)}, torch.from_numpy(x), cfg,
                               update=update)
    assert ty.shape == (2, 4, 3)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        column.train_step({"w": torch.from_numpy(w0)}, torch.from_numpy(x), cfg,
                          update="sometimes")


def test_supervised_targets_take_the_solver_path_only_under_auto():
    jcfg, cfg, w0, x = _small(seed=5)
    target = np.full((4, 3), 16, np.int32)
    target[:, 1] = 3
    jp, _ = jcolumn.train_step({"w": jnp.asarray(w0)}, jnp.asarray(x[0]), jcfg,
                               y_target=jnp.asarray(target))
    tp, _ = column.train_step({"w": torch.from_numpy(w0)}, torch.from_numpy(x[0]),
                              cfg, y_target=torch.from_numpy(target))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="supervised"):
        column.train_step({"w": torch.from_numpy(w0)}, torch.from_numpy(x[0]), cfg,
                          mode="pallas", y_target=torch.from_numpy(target))


def test_registry_and_resolution_match_jax():
    from repro.core import backend as jbackend

    assert backend.names() == jbackend.names() == ("cycle", "event", "pallas")
    jcfg, cfg, _, _ = _small()
    for mode in ("auto", "event", "cycle", "pallas"):
        for training in (False, True):
            assert backend.resolve(mode, cfg, training) == \
                jbackend.resolve(mode, jcfg, training)
    lif = ColumnConfig(p=4, q=2, neuron=NeuronConfig(response="lif"))
    assert backend.resolve("auto", lif, True) == "cycle"
    with pytest.raises(ValueError):
        backend.get("mosaic")


def test_params_round_trip():
    w = np.random.default_rng(0).uniform(0, 7, (5, 2)).astype(np.float32)
    p = column.params_from_jax({"w": jnp.asarray(w)}, device="cpu")
    assert p["w"].dtype == torch.float32 and p["w"].device.type == "cpu"
    np.testing.assert_array_equal(column.params_to_numpy(p)["w"], w)
    with pytest.raises(ValueError):
        column.init_params(ColumnConfig(p=4, q=2), device="cpu", w=w)
