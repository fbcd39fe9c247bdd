"""Port parity, part 20: the dry-run stack (``configs`` shapes,
``launch/hlo.py``, ``launch/dryrun.py``, ``roofline/analysis.py``) and the
sharded model (``transformer.set_mesh``, the MoE's expert-parallel branch).

* The shape table and input stand-ins equal the JAX package's.
* Collective accounting: the same collectives, as HLO text through the
  JAX package's parser and as records through the port's, give equal
  dicts.
* Analysis: the same cells through both ``analyze_cell``s under equal
  profiles give equal rows, markdown and picks; a profile without a link
  bandwidth gives a NaN collective term.
* The dry run end to end on a fake process group of 8 ((2, 4) mesh,
  olmoe smoke), in a subprocess.
* The sharded step's numbers on real tensors: 4 gloo processes, a (2, 2)
  mesh, granite and olmoe smoke: loss and gradients within 1e-5 of the
  largest of the port's unsharded ones.
* ``moe_local_shard`` of each shard index against the JAX package's.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.launch import hlo as jhlo
from repro.models import moe as jmoe
from repro.roofline import analysis as janalysis
from repro.roofline import costmodel as jcostmodel
import repro_torch.configs as C
from repro_torch.launch import hlo
from repro_torch.models import moe
from repro_torch.roofline import analysis
from repro_torch.roofline import costmodel

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(code: str, timeout: int = 300) -> str:
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                       text=True, cwd=ROOT, timeout=timeout,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout


# ------------------------------------------------------------------ shapes
def test_shape_table_equals_jax():
    assert {k: dataclasses.asdict(v) for k, v in C.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_applicable_skip_reason_and_input_specs_equal_jax(arch):
    cfg, jcfg = C.get_arch(arch), JC.get_arch(arch)
    for name in C.SHAPES:
        assert C.applicable(cfg, name) == JC.applicable(jcfg, name)
        assert C.skip_reason(cfg, name) == JC.skip_reason(jcfg, name)
        got = C.input_specs(cfg, C.SHAPES[name])
        want = JC.input_specs(jcfg, JC.SHAPES[name])
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert str(t.dtype).replace("torch.", "") == str(want[k].dtype)


# ------------------------------------------------------ collective accounting
# (kind, result text, replica groups, op_name, async)
_OPS = [
    ("all-gather", "f32[16,128]{1,0}", "replica_groups=[2,4]<=[8]", "jit(step)/ag", False),
    ("all-gather", "(bf16[4,64]{1,0}, bf16[32,64]{1,0})", "replica_groups={{0,1,2,3,4,5,6,7}}",
     "jit(step)/ag_async", True),
    ("all-reduce", "f32[1024]{0}", "replica_groups={{0,1},{2,3},{4,5},{6,7}}", "ar", False),
    ("all-reduce", "(f32[8,8]{1,0}, f32[8,8]{1,0})", "", "ar_async", True),
    ("reduce-scatter", "bf16[8,256]{1,0}", "replica_groups=[4,2]<=[8]", "rs", False),
    ("all-to-all", "s32[64,16]{1,0}", "replica_groups={{0,1,2,3},{4,5,6,7}}", "", False),
    ("collective-permute", "f32[2,3,4]{2,1,0}", "source_target_pairs={{0,1},{1,0}}", "cp",
     False),
    ("collective-permute", "(u8[100]{0}, u8[100]{0})", "", "cp_async", True),
    ("all-gather", "pred[7]{0}", "replica_groups=[1,8]<=[8]", "ag_small", False),
    ("all-reduce", "f64[3,5]{1,0}", "replica_groups=[8,1]<=[8]", "ar_one", False),
]


def _hlo_text() -> str:
    lines = ["HloModule step", "ENTRY %main {"]
    for i, (kind, res, groups, op, is_async) in enumerate(_OPS):
        meta = f', metadata={{op_name="{op}"}}' if op else ""
        g = f", {groups}" if groups else ""
        start = "-start" if is_async else ""
        root = "ROOT " if i == len(_OPS) - 1 else ""
        lines.append(f"  {root}%{kind}{start}.{i} = {res} {kind}{start}(%p.{i}){g}{meta}")
        if is_async:
            lines.append(f"  %{kind}-done.{i} = f32[1]{{0}} {kind}-done(%{kind}{start}.{i})")
    lines.append("}")
    return "\n".join(lines)


def _records() -> list:
    out = []
    for kind, res, groups, op, _ in _OPS:
        n = 0  # all devices
        if groups.startswith("replica_groups=["):
            n = int(groups.split(",")[1].split("]")[0])
        elif groups.startswith("replica_groups={{"):
            n = len(groups[len("replica_groups={{"):].split("}")[0].split(","))
        out.append(hlo.Collective(kind, jhlo._result_bytes(res), n, res[:60], op[:120]))
    return out


@pytest.mark.parametrize("total_devices", [1, 8, 256])
def test_collective_accounting_equals_the_jax_hlo_parser(total_devices):
    want = jhlo.collective_bytes_by_kind(_hlo_text(), total_devices=total_devices)
    got = hlo.collective_bytes_by_kind(_records(), total_devices=total_devices)
    assert got == want
    assert sum(want["counts"].values()) == len(_OPS)  # '-done' halves not counted
    assert len(got["largest"]) == 8


def test_collective_records_skip_waits_and_other_ops():
    """Only ``_c10d_functional`` collectives are recorded (never their
    ``wait_tensor``); the wire bytes follow the ring formulas."""
    out = torch.zeros(8, 4, dtype=torch.bfloat16)

    class Op:
        def __init__(self, name):
            self.overloadpacket = name

    assert hlo.collective_of(Op("_c10d_functional.wait_tensor"), (out,), out) is None
    assert hlo.collective_of(Op("aten.mm"), (out,), out) is None
    assert hlo.wire_bytes("all-gather", 64, 4) == 48
    assert hlo.wire_bytes("reduce-scatter", 64, 4) == 192
    assert hlo.wire_bytes("all-reduce", 64, 4) == 96
    assert hlo.wire_bytes("collective-permute", 64, 4) == 64


# ----------------------------------------------------------------- analysis
@pytest.fixture(scope="module")
def port_cell() -> dict:
    """A cell written by the port's dry run: olmoe smoke on a fake process
    group of 8, a (2, 4) mesh, training (labelled as the olmoe train_4k
    cell for the analysis, which reads its names)."""
    out = _run("""
        import json
        import torch
        import repro_torch.configs as C
        from repro_torch.distributed import sharding
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_mesh

        dryrun.init_fake_world(8)
        mesh = make_mesh((2, 4), ("data", "model"))
        cfg = C.get_arch("olmoe-1b-7b", smoke=True)
        shape = C.ShapeSpec("tiny", "train", 64, 8)
        st = dryrun.build_step(cfg, shape, mesh)
        res = dryrun.run_step(st, mesh.size())
        # the arguments' bytes from the specs alone
        p = dryrun._param_shapes(cfg)
        specs = C.input_specs(cfg, shape)
        from repro_torch.distributed.optimizer import make_optimizer, Schedule
        from repro_torch.distributed.train_loop import _opt_specs
        o = make_optimizer(cfg.optimizer, Schedule()).init(p)
        spec_bytes = (sharding.local_bytes(p, sharding.param_specs(p, mesh), mesh)
                      + sharding.local_bytes(o, _opt_specs(o, p, mesh), mesh)
                      + sharding.local_bytes(specs, sharding.batch_specs(specs, mesh), mesh))
        print(json.dumps({"arch": "olmoe-1b-7b", "shape": "train_4k", "mesh": "single",
                          "status": "ok", "n_chips": 8, "params": cfg.param_count(),
                          "active_params": cfg.active_param_count(), "spec_bytes": spec_bytes,
                          **res}))
    """)
    return json.loads(out.strip().splitlines()[-1])


def test_dryrun_cell_on_tiny_mesh(port_cell):
    """The counterpart of the JAX package's tiny-mesh dry run: FLOPs and
    collective bytes above 0 (TP/EP must move bytes), the arguments' bytes
    exactly the local shard bytes of the specs."""
    assert port_cell["cost_analysis"]["flops"] > 0
    assert port_cell["cost_analysis"]["bytes accessed"] > 0
    coll = port_cell["collective_bytes"]
    assert coll["total"] > 0 and coll["counts"]["all-gather"] > 0
    assert coll["counts"]["all-reduce"] > 0  # the expert shards' sum over model
    mem = port_cell["memory_analysis"]
    assert mem["argument_size_in_bytes"] == port_cell["spec_bytes"]
    assert mem["temp_size_in_bytes"] > 0
    assert mem["alias_size_in_bytes"] <= mem["output_size_in_bytes"]
    peak = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    assert peak == port_cell["peak_live_bytes"]


def _profiles(link_bw: float):
    kw = dict(name="equal", device_kind="test", peak_flops=1.5e14, hbm_bw=2.0e12,
              link_bw=link_bw)
    return (costmodel.DeviceProfile(platform="cuda", **kw),
            jcostmodel.DeviceProfile(platform="tpu", compile_s=1.0, dispatch_s=1e-5,
                                     footprint_bytes=1e6, **kw))


def _cells(port_cell) -> list:
    skipped = {"arch": "granite-3-8b", "shape": "long_500k", "mesh": "single",
               "status": "skipped", "reason": "pure full-attention"}
    extrapolated = {
        "arch": "kimi-k2-1t-a32b", "shape": "decode_32k", "mesh": "single", "status": "ok",
        "n_chips": 256, "active_params": 32e9,
        "memory_analysis": {"argument_size_in_bytes": 9e9, "output_size_in_bytes": 3e9,
                            "temp_size_in_bytes": 2e9, "alias_size_in_bytes": 3e9},
        "cost_analysis": {"flops": 1e9, "bytes accessed": 5e9},
        "collective_bytes": {"total": 1e6},
        "extrapolated": {"flops": 2e11, "bytes accessed": 7e11,
                         "collective_bytes": {"total": 4e9}},
    }
    cell = {k: v for k, v in port_cell.items() if k not in ("spec_bytes", "peak_live_bytes")}
    return [skipped, extrapolated, cell]


def test_analysis_equals_jax(port_cell):
    prof, jprof = _profiles(link_bw=4.5e11)
    cells = _cells(port_cell)
    with costmodel.override(prof), jcostmodel.override(jprof):
        rows = [analysis.analyze_cell(c) for c in cells]
        jrows = [janalysis.analyze_cell(c) for c in cells]
    assert [dataclasses.asdict(r) for r in rows] == [dataclasses.asdict(r) for r in jrows]
    assert analysis.render_markdown(rows) == janalysis.render_markdown(jrows)
    picks = analysis.pick_hillclimb_cells(rows)
    jpicks = janalysis.pick_hillclimb_cells(jrows)
    assert {k: dataclasses.asdict(v) for k, v in picks.items()} == {
        k: dataclasses.asdict(v) for k, v in jpicks.items()}
    # an explicit profile wins over the active one
    assert analysis.analyze_cell(cells[2], prof).compute_s == rows[2].compute_s


def test_analysis_without_link_bandwidth_has_no_collective_term(port_cell):
    prof, _ = _profiles(link_bw=0.0)
    row = analysis.analyze_cell(_cells(port_cell)[2], prof)
    assert math.isnan(row.collective_s) and row.note == analysis.NO_LINK_NOTE
    assert row.dominant in ("compute", "memory")
    assert row.bound_s == max(row.compute_s, row.memory_s)
    assert row.roofline_fraction > 0
    # the default is the card's data-sheet profile, which has no link
    assert analysis.peaks()[2] == 0.0 and analysis.peaks()[3] == "h100-sxm"
    assert "nan" in analysis.render_markdown([row])


def test_dryrun_cli_lists_cells_and_hillclimb_coerces():
    out = _run("""
        from repro_torch.launch import dryrun
        dryrun.main(["--list"])
    """)
    cells = [line.split() for line in out.strip().splitlines()]
    assert len(cells) == len(C.ARCH_IDS) * len(C.SHAPES) * 2
    from repro_torch.launch import hillclimb

    cfg = C.get_arch("granite-3-8b")
    assert hillclimb._coerce(cfg, "kv_chunk", "2048") == 2048
    assert hillclimb._coerce(cfg, "attn_bf16_scores", "true") is True
    assert hillclimb._coerce(cfg, "moe_impl", "ragged") == "ragged"
    assert hillclimb._coerce(cfg, "moe_capacity_factor", "1.5") == 1.5


# ---------------------------------------------------- numbers on real tensors
_GLOO = """
import os, socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCH = sys.argv[1]


def flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, path + (key,)).items()}
    return {path: tree}


def run(rank, port, q):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    torch.manual_seed(0)
    import repro_torch.configs as C
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T

    cfg = C.get_arch(ARCH, smoke=True)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    (loss, _), grads = T.loss_and_grads(model, batch)
    grads = {k: v.clone() for k, v in flat(grads).items()}

    mesh = make_mesh((2, 2), ("data", "model"))
    T.set_mesh(mesh)
    ptree = T.param_tree(T.init_params(cfg, generator=torch.Generator().manual_seed(7),
                                       device="cpu"))
    params = sharding.to_shardings(ptree, sharding.param_specs(ptree, mesh), mesh)
    sharded = dryrun._model_from(params, cfg)
    b = sharding.to_shardings(batch, sharding.batch_specs(batch, mesh), mesh)
    with T.mesh_scope():
        (sloss, _), sgrads = T.loss_and_grads(sharded, b)
        sloss = sloss.full_tensor()
        full = {k: v.full_tensor() for k, v in flat(sgrads).items()}
    errs = {"/".join(k): float((full[k] - g).abs().max() / g.abs().max().clamp_min(1e-30))
            for k, g in grads.items()}
    if rank == 0:
        q.put((float(loss), float(sloss), errs))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=run, args=(r, port, q)) for r in range(4)]
    for p in procs:
        p.start()
    loss, sloss, errs = q.get(timeout=240)
    for p in procs:
        p.join(60)
        assert p.exitcode == 0
    print(repr((loss, sloss, errs)))
"""


@pytest.mark.parametrize("arch", ["granite-3-8b", "olmoe-1b-7b"])
def test_sharded_loss_and_grads_equal_unsharded_on_gloo(arch, tmp_path):
    """granite: FSDP + TP (heads, MLP, vocab); olmoe: the experts over
    ``model`` (the expert-parallel branch; cf 4.0 drops nothing in either
    layout).  4 CPU processes, a (2, 2) mesh, f32."""
    script = tmp_path / "gloo_step.py"
    script.write_text(_GLOO)
    r = subprocess.run([sys.executable, str(script), arch], capture_output=True, text=True,
                       cwd=ROOT, timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-4000:]
    loss, sloss, errs = eval(r.stdout.strip().splitlines()[-1])
    assert abs(loss - sloss) <= 1e-5 * abs(loss), (loss, sloss)
    assert len(errs) > 10
    bad = {k: e for k, e in errs.items() if not e <= 1e-5}
    assert not bad, bad


# ------------------------------------------------------------- MoE shards
@pytest.mark.parametrize("impl", ["gathered", "ragged"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_moe_local_shard_equals_jax_per_shard(impl, n_shards):
    """Each shard's partial output on its own expert slice, at cf 2.0 with
    experts 0 and 1 overflowing (test_torch_moe's inputs and tolerance);
    the shards sum to the one-shard output."""
    cfg = dataclasses.replace(C.get_arch("olmoe-1b-7b", smoke=True),
                              moe_capacity_factor=2.0, moe_impl=impl)
    jcfg = dataclasses.replace(JC.get_arch("olmoe-1b-7b", smoke=True),
                               moe_capacity_factor=2.0, moe_impl=impl)
    rng = np.random.default_rng(1)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": (rng.normal(size=(D, E)) / np.sqrt(D)).astype(np.float32),
         "w_gate": (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32),
         "w_up": (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32),
         "w_down": (rng.normal(size=(E, F, D)) / np.sqrt(F)).astype(np.float32)}
    p["router"][0, :2] = 3.0
    x = np.random.default_rng(2).normal(size=(63, D)).astype(np.float32)
    x[:, 0] = 1.0
    E_loc = E // n_shards
    total = 0
    for i in range(n_shards):
        sl = {k: v if k == "router" else v[i * E_loc:(i + 1) * E_loc] for k, v in p.items()}
        got = moe.moe_local_shard(torch.from_numpy(x), {k: torch.from_numpy(v)
                                                       for k, v in sl.items()}, cfg, i, n_shards)
        want = np.asarray(jmoe.moe_local_shard(jnp.asarray(x), {k: jnp.asarray(v)
                                                                for k, v in sl.items()},
                                               jcfg, jnp.int32(i), n_shards))
        err = np.abs(got.numpy() - want).max() / (np.abs(want).max() + 1e-9)
        assert err < 1e-5, (i, err)
        total = total + got.numpy()
    one = moe.moe_local_shard(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                              cfg).numpy()
    if impl == "gathered":  # the same capacity per expert at any shard count
        np.testing.assert_allclose(total, one, rtol=1e-5, atol=1e-5 * np.abs(one).max())
