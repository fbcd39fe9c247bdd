"""Port parity, part 1: configs, UCR copy, metrics, encoders, and the
port's import and device rules.

The same numpy inputs go through the JAX package and the port.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.clustering import metrics as jmetrics
from repro.configs import tnn_columns as jcols
from repro.core import encoding as jenc
from repro.core import types as jtypes
from repro.data import ucr as jucr
from repro_torch.clustering import metrics as tmetrics
from repro_torch.configs import tnn_columns as tcols
from repro_torch.core import encoding as tenc
from repro_torch.core import types as ttypes

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _configs(types):
    col = types.ColumnConfig(
        p=13, q=3, t_max=40,
        neuron=types.NeuronConfig(response="snl", threshold=9.5, w_max=5,
                                  leak=0.25, refractory=2),
        wta=types.WTAConfig(k=2, tie_break="all"),
        stdp=types.STDPConfig(mu_capture=0.25, stabilizer="none"),
    )
    layer = types.LayerConfig(columns=4, column=col, connectivity="tiled")
    return [
        types.NeuronConfig(), types.WTAConfig(), types.STDPConfig(),
        types.ColumnConfig(p=5, q=2), col, layer,
        types.NetworkConfig(layers=(layer, layer), name="two"),
    ]


@pytest.mark.parametrize("i", range(7))
def test_config_asdict_agrees_field_for_field(i):
    j, t = _configs(jtypes)[i], _configs(ttypes)[i]
    assert type(j).__name__ == type(t).__name__
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_column_config_round_trip_and_dtypes():
    col = _configs(ttypes)[4]
    d = dataclasses.asdict(_configs(jtypes)[4])
    assert ttypes.column_config_from_dict(d) == col
    assert col.with_threshold(3.0).neuron.threshold == 3.0
    assert col.synapse_count == 39
    assert ttypes.TIME_DTYPE == torch.int32
    assert ttypes.WEIGHT_DTYPE == torch.float32
    assert ttypes.no_spike(64) == jtypes.no_spike(64) == 64
    with pytest.raises(ValueError):
        ttypes.NeuronConfig(response="tanh")


@pytest.mark.parametrize("name", sorted(jucr.BENCHMARKS))
def test_ucr_copy_gives_equal_arrays(name):
    from repro_torch.data import ucr as tucr

    a, b = jucr.load(name), tucr.load(name)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    assert a.synthetic == b.synthetic and a.n_classes == b.n_classes


def test_ucr_tables_and_column_configs_agree():
    from repro_torch.data import ucr as tucr

    assert tucr.BENCHMARKS == jucr.BENCHMARKS
    assert tucr.PAPER_COLUMNS == jucr.PAPER_COLUMNS
    assert tucr.PAPER_RAND_INDEX == jucr.PAPER_RAND_INDEX
    assert tcols.all_benchmarks() == jcols.all_benchmarks()
    for name in jcols.all_benchmarks():
        assert dataclasses.asdict(tcols.column_config(name)) == \
            dataclasses.asdict(jcols.column_config(name))


@pytest.mark.parametrize("seed", range(3))
def test_rand_index_agrees(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 4, 50), rng.integers(0, 3, 50)
    assert tmetrics.rand_index(a, b) == jmetrics.rand_index(a, b)
    assert tmetrics.normalized_rand(0.5, 0.8) == jmetrics.normalized_rand(0.5, 0.8)


def test_round_is_half_to_even_in_both():
    v = np.array([0.5, 1.5, 2.5, -0.5, 3.5], np.float32)
    np.testing.assert_array_equal(
        torch.round(torch.from_numpy(v)).numpy(), np.asarray(jnp.round(v))
    )
    np.testing.assert_array_equal(np.asarray(jnp.round(v)), [0, 2, 2, -0, 4])


@pytest.mark.parametrize("encoder", ["latency", "onoff"])
def test_encoders_agree(encoder):
    x = jucr.load("ECG200").x[:30]
    # a flat series and exact half-way samples hit the rounding edges
    x = np.concatenate([x, np.zeros((1, x.shape[1])), np.tile(
        np.linspace(0, 1, 127)[:96], (1, 1))])
    for t_max in (64, 128):
        j = np.asarray(jenc.encode(jnp.asarray(x), t_max, encoder))
        t = tenc.encode(torch.as_tensor(x, dtype=torch.float32), t_max, encoder)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), j)
    assert tenc.encoded_width(96, encoder) == jenc.encoded_width(96, encoder)
    with pytest.raises(ValueError):
        tenc.encode(torch.zeros(3), 8, "rate")


def test_latency_encode_without_normalize_agrees():
    v = np.random.default_rng(0).uniform(-0.2, 1.2, (4, 17)).astype(np.float32)
    j = np.asarray(jenc.latency_encode(jnp.asarray(v), 32, normalize=False))
    t = tenc.latency_encode(torch.from_numpy(v), 32, normalize=False)
    np.testing.assert_array_equal(t.numpy(), j)


def test_import_leaves_jax_and_repro_out():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
        "repro_torch.configs.tnn_columns, repro_torch.data.ucr, "
        "repro_torch.clustering.metrics, repro_torch.clustering.kmeans, "
        "repro_torch.clustering.dtcr, repro_torch.roofline.costmodel, "
        "repro_torch.serve, "
        "repro_torch.testing, repro_torch.distributed.checkpoint, "
        "repro_torch.launch.serve_tnn, repro_torch.distributed.sharding, "
        "repro_torch.distributed.train_loop, repro_torch.launch.mesh, "
        "repro_torch.launch.hlo, repro_torch.launch.dryrun, "
        "repro_torch.launch.hillclimb, repro_torch.roofline.analysis\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_no_port_file_names_jax_or_repro():
    files = [f for f in (SRC / "repro_torch").rglob("*")
             if f.suffix in (".py", ".cu", ".cuh")]
    assert len(files) >= 20
    for f in files:
        text = f.read_text()
        assert not re.search(r"\bjax\b", text), f
        assert not re.search(r"\brepro\.", text), f


def test_entry_points_without_device_raise_on_a_host_without_cuda(monkeypatch):
    from repro_torch.core import backend, column, simulator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttypes.ColumnConfig(p=4, q=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        column.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        column.params_from_jax({"w": np.zeros((4, 2))})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.cluster_time_series(np.zeros((3, 4)), None, cfg)
    from repro_torch.launch import serve_tnn
    from repro_torch.serve import ClusteringService

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusteringService({"d0": cfg.with_threshold(2.0)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_tnn.main(["--smoke"])
    assert backend.default_device("cpu") == torch.device("cpu")


def test_baselines_and_calibration_without_device_raise_on_a_host_without_cuda(
        monkeypatch):
    from repro_torch.clustering import dtcr, kmeans

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).normal(size=(6, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kmeans.kmeans(x, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dtcr.fit_predict(x, dtcr.DTCRConfig(steps=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dtcr.init_params(torch.Generator().manual_seed(0), dtcr.DTCRConfig())
