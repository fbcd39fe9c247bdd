"""The port's durable serving against the JAX package's: snapshot + WAL
crash recovery.

* The WAL reader tolerates a torn trailing line; ``truncate_through``
  keeps the newer tail; a WAL either package wrote validates in the
  other, and the two services' replay specs hash to the same
  fingerprint.
* ``ClusteringService.recover(dir)`` rebuilds the fleet, restores the
  newest snapshot and replays the WAL tail: weights bit-identical to the
  live service and to the JAX package's recovered service on the same
  injected weights and stream; a tampered fleet is refused; snapshot
  retention stays bounded; a drain publishes a final snapshot.
* A REAL ``python -m repro_torch.launch.serve_tnn --device cpu
  --durable-dir ...`` process is SIGKILLed right after its third WAL
  append; the directory recovers to weights bit-identical to an
  uninterrupted run of the same stream, and the launcher resumes it.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.core import simulator as jsim
from repro.core import types as jtypes
from repro.serve import ClusteringService as JService
from repro.serve import durability as jdur
from repro_torch.core import simulator
from repro_torch.core import types as ttypes
from repro_torch.serve import ClusteringService, RequestRejected, durability
from repro_torch.serve.durability import DurableStore, VolleyWAL

P, T_MAX = 12, 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_STDP = dict(mu_capture=1.0, mu_backoff=1.0, mu_search=1.0,
                 stabilizer="none")


def _cfg(types=ttypes, sim=simulator, q=4, grid=False):
    stdp = types.STDPConfig(**GRID_STDP) if grid else types.STDPConfig()
    c = types.ColumnConfig(p=P, q=q, t_max=T_MAX, stdp=stdp)
    return c.with_threshold(sim.suggest_threshold(c))


def _fleet(n=2, types=ttypes, sim=simulator, grid=False) -> dict:
    return {f"d{i}": _cfg(types, sim, q=3 + (i % 2), grid=grid)
            for i in range(n)}


def _weights(fleet, seed=0, grid=False) -> dict:
    rng = np.random.default_rng(seed)
    return {n: (rng.integers(0, 8, (c.p, c.q)) if grid
                else rng.uniform(0, 7, (c.p, c.q))).astype(np.float32)
            for n, c in fleet.items()}


def _service(fleet, **kw):
    return ClusteringService(fleet, device="cpu", **kw)


def _drive(service, rng, n, names=None):
    names = names or list(service.designs())
    for k in range(n):
        service.submit(rng.normal(size=P), names[k % len(names)])
    service.flush()


# ------------------------------------------------------------------ WAL
def test_wal_header_append_and_torn_tail(tmp_path):
    wal = VolleyWAL(str(tmp_path / "wal.jsonl"))
    wal.create("fp16")
    wal.append({"kind": "refit", "seq": 1, "bucket": 0, "xs": [[1, 2]]})
    wal.append({"kind": "refit", "seq": 2, "bucket": 0, "xs": [[3, 4]]})
    assert [r["seq"] for r in wal.validate("fp16")] == [1, 2]
    with open(wal.path, "a") as f:
        f.write('{"kind": "refit", "seq": 3, "xs": [[5')
    assert [r["seq"] for r in wal.validate("fp16")] == [1, 2]
    with pytest.raises(ValueError, match="fingerprint"):
        wal.validate("other")


def test_wal_truncate_through_keeps_newer_tail(tmp_path):
    wal = VolleyWAL(str(tmp_path / "wal.jsonl"))
    wal.create("fp")
    for seq in (1, 2, 3):
        wal.append({"kind": "refit", "seq": seq, "bucket": 0, "xs": []})
    wal.truncate_through(2, "fp")
    assert [r["seq"] for r in wal.validate("fp")] == [3]
    assert wal.load()[0]["kind"] == "meta"
    with pytest.raises(ValueError, match="header"):
        VolleyWAL(str(tmp_path / "missing.jsonl")).validate("fp")


def test_wal_and_fingerprint_shared_with_the_jax_package(tmp_path):
    """A WAL the JAX package wrote validates in the port and the other
    way round, and the same fleet hashes to the same replay fingerprint
    in both services."""
    j = jdur.VolleyWAL(str(tmp_path / "j.jsonl"))
    j.create("fp")
    j.append({"kind": "refit", "seq": 1, "bucket": 0, "xs": [[1, 2]]})
    assert VolleyWAL(j.path).validate("fp") == jdur.VolleyWAL(j.path).validate("fp")
    t = VolleyWAL(str(tmp_path / "t.jsonl"))
    t.create("fp")
    t.append({"kind": "refit", "seq": 4, "bucket": 1, "xs": [[3]]})
    assert jdur.VolleyWAL(t.path).validate("fp")[0]["seq"] == 4
    assert durability.DURABLE_VERSION == jdur.DURABLE_VERSION
    spec = _service(_fleet(), seed=3)._replay_spec()
    jspec = JService(_fleet(types=jtypes, sim=jsim), seed=3)._replay_spec()
    assert spec == jspec
    assert durability.service_fingerprint(spec) == jdur.service_fingerprint(jspec)


def test_durable_store_refuses_reuse_and_validates(tmp_path):
    service = _service(_fleet(), batch_size=4, refit_every=0,
                       durable_dir=str(tmp_path / "svc"))
    assert service.stats().snapshots == 0
    with pytest.raises(ValueError, match="recover"):
        _service(_fleet(), batch_size=4, refit_every=0,
                 durable_dir=str(tmp_path / "svc"))
    store = DurableStore(str(tmp_path / "svc"))
    assert store.exists() and store.ckpt.latest_step() == 0
    with pytest.raises(ValueError, match="fingerprint"):
        store.attach("0000000000000000")
    with pytest.raises(FileNotFoundError, match="no durable service"):
        DurableStore(str(tmp_path / "empty")).load_meta()


# ------------------------------------------------------------- recovery
@pytest.mark.parametrize("grid", [True, False], ids=["grid", "stabilizer"])
def test_recover_mid_wal_is_bit_identical_and_keeps_serving(tmp_path, grid):
    """Snapshot at seq 8 + a 2-record WAL tail: recovery replays the tail
    and matches the live service bit for bit (weights and the next
    batch's ids), and the JAX package's recovered service on the same
    weights and stream (bit-equal on the grid, 1e-6 off it)."""
    tf, jf = _fleet(grid=grid), _fleet(types=jtypes, sim=jsim, grid=grid)
    kw = dict(batch_size=4, refit_every=4, refit_window=4, seed=7,
              snapshot_every=4, weights=_weights(tf, 1, grid))
    live = _service(tf, durable_dir=str(tmp_path / "svc"), **kw)
    jlive = JService(jf, durable_dir=str(tmp_path / "jsvc"), **kw)
    live.warmup()
    jlive.warmup()
    _drive(live, np.random.default_rng(1), 40)
    _drive(jlive, np.random.default_rng(1), 40)
    st = live.stats()
    assert st.refits == 10 and st.snapshots == 2 and st.wal_records == 2

    rec = ClusteringService.recover(str(tmp_path / "svc"), device="cpu")
    jrec = JService.recover(str(tmp_path / "jsvc"))
    assert rec.stats().replayed == jrec.stats().replayed == 2
    for d in live.designs():
        np.testing.assert_array_equal(live.weights(d), rec.weights(d))
        want = np.asarray(jrec.weights(d))
        if grid:
            np.testing.assert_array_equal(rec.weights(d), want)
        else:
            np.testing.assert_allclose(rec.weights(d), want, rtol=1e-6, atol=1e-6)

    rec.warmup()
    names = list(live.designs())
    rng = np.random.default_rng(5)
    xs = [rng.normal(size=P) for _ in range(8)]
    a = [live.submit(x, names[i % 2]).result().cluster for i, x in enumerate(xs)]
    b = [rec.submit(x, names[i % 2]).result().cluster for i, x in enumerate(xs)]
    assert a == b


def test_recover_refuses_mismatched_fleet(tmp_path):
    _service(_fleet(), batch_size=4, refit_every=0,
             durable_dir=str(tmp_path / "svc"))
    meta_path = tmp_path / "svc" / durability.META_FILE
    meta = json.loads(meta_path.read_text())
    meta["spec"]["seed"] = 999
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="fingerprint"):
        ClusteringService.recover(str(tmp_path / "svc"), device="cpu")


def test_snapshot_retention_stays_bounded(tmp_path):
    service = _service(_fleet(1), batch_size=4, refit_every=4, refit_window=4,
                       durable_dir=str(tmp_path / "svc"), snapshot_every=1,
                       seed=0)
    service.warmup()
    _drive(service, np.random.default_rng(2), 24)
    assert service.stats().snapshots == 6
    store = DurableStore(str(tmp_path / "svc"))
    steps = store.ckpt.steps()
    assert len(steps) <= durability.SNAPSHOTS_KEPT
    assert steps[-1] == store.ckpt.latest_step() == 6


def test_drain_publishes_final_snapshot(tmp_path):
    service = _service(_fleet(), batch_size=4, refit_every=4, refit_window=4,
                       seed=3, durable_dir=str(tmp_path / "svc"),
                       snapshot_every=4)
    service.warmup()
    rng = np.random.default_rng(3)
    _drive(service, rng, 12)
    assert service.stats().wal_records == 3
    final = service.drain()
    assert final.wal_records == 0
    with pytest.raises(RequestRejected, match="draining"):
        service.submit(rng.normal(size=P), "d0")
    rec = ClusteringService.recover(str(tmp_path / "svc"), device="cpu")
    assert rec.stats().replayed == 0
    for d in service.designs():
        np.testing.assert_array_equal(service.weights(d), rec.weights(d))


def test_recover_without_device_raises_on_a_host_without_cuda(tmp_path, monkeypatch):
    _service(_fleet(), durable_dir=str(tmp_path / "svc"))
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusteringService.recover(str(tmp_path / "svc"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusteringService(_fleet())


# ------------------------------------------------------ SIGKILL the serve
LAUNCH_ARGS = ["--device", "cpu", "--designs", "2", "--streams", "8",
               "--requests", "16", "--batch", "4", "--refit-every", "8",
               "--length", str(P), "--t-max", str(T_MAX), "--seed", "0"]


def _launcher_reference(n_refits: int) -> ClusteringService:
    """The launcher's fleet and stream (``launch/serve_tnn.py`` at
    ``LAUNCH_ARGS``) in this process, driven until ``n_refits`` re-fits
    have committed."""
    cfgs = {}
    for i in range(2):
        c = ttypes.ColumnConfig(p=P, q=3 + 2 * (i % 2),
                                t_max=T_MAX * (1 + (i // 2) % 2))
        cfgs[f"nspu{i}"] = c.with_threshold(simulator.suggest_threshold(c))
    service = _service(cfgs, batch_size=4, refit_every=8, refit_window=8,
                       seed=0, waste_cap=2.0)
    service.warmup()
    names = list(service.designs())
    streams = [np.random.default_rng(s) for s in range(8)]
    for _ in range(16):
        for s, rng in enumerate(streams):
            service.submit(rng.normal(size=P), names[s % len(names)])
            if service.stats().refits == n_refits:
                return service
    raise AssertionError(f"the stream committed fewer than {n_refits} re-fits")


def test_serve_tnn_sigkill_recover_is_bit_identical(tmp_path):
    """Acceptance: ``python -m repro_torch.launch.serve_tnn --device cpu
    --durable-dir`` SIGKILLed right after its third WAL append recovers
    to weights bit-identical to an uninterrupted run of the same stream
    through the same three re-fits; the launcher then resumes the
    directory and serves to the end."""
    dd = str(tmp_path / "svc")
    code = textwrap.dedent(f"""
        import os, runpy, signal, sys
        from repro_torch.serve import durability

        orig_append = durability.VolleyWAL.append
        count = [0]

        def killing_append(self, record):
            orig_append(self, record)  # the record IS durable
            count[0] += 1
            if count[0] == 3:
                os.kill(os.getpid(), signal.SIGKILL)

        durability.VolleyWAL.append = killing_append
        sys.argv = ["serve_tnn", *{LAUNCH_ARGS!r}, "--durable-dir", {dd!r}]
        runpy.run_module("repro_torch.launch.serve_tnn", run_name="__main__",
                         alter_sys=True)
        raise SystemExit("unreachable: the third WAL append must kill us")
    """)
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-2000:])

    rec = ClusteringService.recover(dd, device="cpu")
    assert rec.stats().replayed == 3
    ref = _launcher_reference(3)
    for d in ref.designs():
        np.testing.assert_array_equal(
            ref.weights(d), rec.weights(d),
            err_msg=f"{d}: recovered weights differ from the uninterrupted run")
    rec.warmup()
    rng = np.random.default_rng(9)
    xs = [rng.normal(size=P) for _ in range(8)]
    names = list(ref.designs())
    a = [ref.submit(x, names[i % 2]).result().cluster for i, x in enumerate(xs)]
    b = [rec.submit(x, names[i % 2]).result().cluster for i, x in enumerate(xs)]
    assert a == b

    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_tnn", *LAUNCH_ARGS,
         "--durable-dir", dd],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "[serve_tnn] resumed durable service" in r.stdout


def test_serve_tnn_smoke_drains_on_its_own_sigterm():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_tnn", "--smoke",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH="src"), timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "SIGTERM: draining" in r.stdout and "drained cleanly" in r.stdout
