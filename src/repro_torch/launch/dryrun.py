"""Multi-pod dry run: run every (architecture x input-shape) cell's step
once on the production meshes, on fake tensors, and record its memory,
cost and collectives.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs 2]
    python -m repro_torch.launch.dryrun --list

The port's counterpart of the JAX package's ``launch/dryrun.py``, which
lowers and compiles each cell on 512 forced host devices and reads XLA's
analyses.  PyTorch has no SPMD compiler.  Here the process joins a fake
process group of the mesh's size (rank 0 of 256 for ``single``, 512 for
``multi``: ``torch.distributed``'s ``fake`` backend, whose collectives
move nothing), the parameters, optimizer state, batch and cache are
``DTensor``s over that ``DeviceMesh`` laid out by
``distributed/sharding.py``, and their local tensors are ``FakeTensor``s,
so nothing is allocated.  The step (``transformer.train_step_fn``,
``prefill`` or ``decode_step``, on ``transformer.set_mesh(mesh)``) runs
once under ``_Counter``, a dispatch mode that sees the local ops and the
collectives DTensor issues.  It writes the JAX package's keys, per
device:

  memory_analysis   argument_size_in_bytes (local parameters, optimizer
                    state, batch and cache), output_size_in_bytes (what the
                    step returns), alias_size_in_bytes (the part of it
                    written in place: parameters and optimizer state in
                    training, the cache in decode), temp_size_in_bytes
                    (the peak of live bytes, each storage rounded up to
                    512 B as the CUDA caching allocator does, minus the
                    arguments and the outputs' own buffers), so that
                    argument + temp + output - alias is the peak;
  cost_analysis     flops (``torch.utils.flop_counter``'s formulas: matrix
                    products and attention only, where XLA counts every
                    op) and bytes accessed (operand plus result bytes of
                    every non-view op, unfused: no fusion is modelled);
  collective_bytes  ``launch/hlo.py``'s accounting of the recorded
                    collectives;
  trace_s           seconds to build and run the step (the JAX dry run's
                    lower_s / compile_s).

Every lowering is the plain version (the tensors are on the CPU), as the
JAX dry run counts the jnp ``chunked_attention``.  The eager step runs
every layer, so the counts are whole: the JAX package's unrolled cost
variants and their extrapolation (``_cost_variant``, ``_extrapolate``)
have no counterpart and a cell has no ``extrapolated`` key.  A decode
cell attends over a full cache: its 'len' is seq_len - 1, where the JAX
program reads the whole cache under a mask.  The MoE's ``moe_impl=
'ragged'`` reads group sizes on the host and cannot run on fake tensors.

``--all`` fans cells out to subprocesses (a fresh process group per
cell).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import weakref
from typing import Callable

import torch

import repro_torch.configs as C
from repro_torch.distributed import sharding
from repro_torch.distributed.optimizer import Schedule, make_optimizer, tree_map
from repro_torch.launch.hlo import CollectiveRecorder, collective_bytes_by_kind, collective_of
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig

RESULTS_DIR = "results/dryrun"
ALLOC_ROUND = 512  # the CUDA caching allocator's block granularity


def init_fake_world(world_size: int) -> None:
    """Join a fake process group of ``world_size`` ranks as rank 0 (no
    other process exists; collectives return at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _param_shapes(cfg: ArchConfig) -> dict:
    """The layer-stacked parameter tree of a model built on ``meta``."""
    model = T.init_params(cfg, generator=torch.Generator(), device="meta")
    return T.param_tree(model)


def _cache_shapes(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    enc = cfg.enc_seq if cfg.family == "audio" else 0
    return T.init_cache(cfg, batch, max_len, device="meta", enc_len=enc)


def _fake(tree):
    """Plain tensors of the leaves' shapes and dtypes (fake ones, under a
    ``FakeTensorMode``); other leaves pass through."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def _model_from(params: dict, cfg: ArchConfig) -> T.Transformer:
    """A ``Transformer`` whose layers' weights are slices of the stacked
    tree's leaves (``param_tree``, which training binds, restacks them)."""
    def layer(sub, i):
        return {k: layer(v, i) for k, v in sub.items()} if isinstance(sub, dict) else sub[i]

    n = {"blocks": cfg.n_layers, "enc_blocks": cfg.enc_layers, "cross_blocks": cfg.n_layers}
    w = {k: [layer(v, i) for i in range(n[k])] if k in T._STACKED else v
         for k, v in params.items()}
    return T.Transformer(w, cfg)


@dataclasses.dataclass
class Step:
    """A cell's step and its arguments (``DTensor``s of fake tensors),
    run as ``fn(*args)`` under ``fake``."""
    fn: Callable
    args: tuple
    fake: object
    arg_trees: tuple     # the trees whose local bytes are the arguments
    state: tuple         # other storage alive before the step (gradient buffers)
    aliased: Callable    # output -> the trees of it written in place


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def tensor_bytes(*trees) -> int:
    """Bytes of the local tensors of every tensor leaf (each once)."""
    seen, total = set(), 0
    for tree in trees:
        for t in _leaves(tree):
            lt = _local(t)
            if id(lt) not in seen:
                seen.add(id(lt))
                total += lt.numel() * lt.element_size()
    return total


def serve_replicated(cfg: ArchConfig, shape: C.ShapeSpec, mesh) -> bool:
    """The JAX dry run's rule: serving drops the FSDP factor whenever the
    TP-sharded weights fit (everything but kimi-k2)."""
    return (shape.kind != "train"
            and cfg.param_count() * 2 / sharding.axis_size(mesh, "model") < 12e9)


def build_step(cfg: ArchConfig, shape: C.ShapeSpec, mesh) -> Step:
    """The cell's step and its sharded fake arguments (the JAX package's
    ``build_lowered``): train ``train_step_fn`` (loss, gradients, the
    optimizer's update; optimizer state by ``_opt_specs``), prefill
    ``prefill`` into a sharded cache made in the step, decode one token
    against a seq_len cache."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.train_loop import _opt_specs

    T.set_mesh(mesh)
    p_meta = _param_shapes(cfg)
    p_specs = sharding.param_specs(p_meta, mesh, serve=serve_replicated(cfg, shape, mesh))
    specs = C.input_specs(cfg, shape)
    b_specs = sharding.batch_specs(specs, mesh)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        params = sharding.to_shardings(_fake(p_meta), p_specs, mesh)
        model = _model_from(params, cfg)
        batch = sharding.to_shardings(_fake(specs), b_specs, mesh)
        if shape.kind == "train":
            params = T.param_tree(model)  # the optimizer's stacked view
            grads = T._view(model).grads
            opt = make_optimizer(cfg.optimizer, Schedule())
            o_full = opt.init(_fake(p_meta))
            opt_state = sharding.to_shardings(o_full, _opt_specs(o_full, p_meta, mesh), mesh)
            step = T.train_step_fn(cfg, opt)

            def train(model, opt_state, batch):
                with T.mesh_scope():
                    model, opt_state, metrics = step(model, opt_state, batch)
                return T.param_tree(model), opt_state, metrics

            return Step(train, (model, opt_state, batch), fake, (params, opt_state, batch),
                        (grads,), lambda out: (out[0], out[1]))
        c_meta = _cache_shapes(cfg, shape.global_batch, shape.seq_len)
        c_specs = sharding.cache_specs(c_meta, mesh)
        if shape.kind == "prefill":
            def prefill(model, batch):
                with torch.no_grad(), T.mesh_scope():
                    cache = sharding.to_shardings(_fake(c_meta), c_specs, mesh)
                    return T.prefill(model, batch["tokens"], shape.seq_len,
                                     frames=batch.get("frames"), cache=cache)

            return Step(prefill, (model, batch), fake, (params, batch), (),
                        lambda out: ())
        cache = sharding.to_shardings(_fake(c_meta), c_specs, mesh)
        cache["len"] = shape.seq_len - 1

        def decode(model, cache, batch):
            with torch.no_grad(), T.mesh_scope():
                return T.decode_step(model, cache, batch["tokens"])

        return Step(decode, (model, cache, batch), fake, (params, cache, batch), (),
                    lambda out: (out[0],))


# ops that only ask for metadata (FlopCounterMode skips them too)
_META_OPS = frozenset(
    getattr(torch.ops.aten, n).default for n in (
        "is_contiguous", "size", "sym_size", "stride", "sym_stride", "storage_offset",
        "sym_storage_offset", "numel", "sym_numel", "dim", "sym_is_contiguous",
        "is_non_overlapping_and_dense") if hasattr(torch.ops.aten, n))


class _Counter(CollectiveRecorder):
    """Counts what one device does while a step runs on DTensors: on
    ``DTensor`` arguments it steps aside, so it sees the local ops and the
    collectives DTensor issues.  FLOPs by ``torch.utils.flop_counter``'s
    formulas, decomposing an op it has none for as ``FlopCounterMode``
    does; bytes accessed by operand plus result bytes of non-view ops;
    live bytes by the storages the ops make, each released when its last
    tensor dies (``weakref.finalize``)."""

    def __init__(self, module=lambda: ""):
        super().__init__(module)
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.paused = 0
        self._held: dict = {}

    def hold(self, t: torch.Tensor) -> None:
        """Track the storage of ``t`` (a local tensor) from now on."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if func in _META_OPS or any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self.paused:  # DTensor deriving an op's global shape: no device work
            return func(*args, **kwargs)
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        rec = collective_of(func, args, out, self.module())
        if rec is not None:
            self.records.append(rec)
            return out
        packet = func.overloadpacket
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out)
        outs = list(_leaves(out))
        if not func.is_view and str(packet) != "_c10d_functional.wait_tensor":
            self.bytes += sum(t.numel() * t.element_size()
                              for t in list(_leaves((args, kwargs))) + outs)
        for t in outs:
            self.hold(t)
        return out


@contextlib.contextmanager
def _shape_propagation_paused(counter: "_Counter"):
    """DTensor derives an op's global output shape by running it once on
    fake tensors of the global shapes (then caches it); those runs are not
    the device's work, so the counter pauses inside them.  This wraps a
    private method of ``torch.distributed.tensor``'s ``ShardingPropagator``."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def paused(self, op_schema):
        counter.paused += 1
        try:
            return orig(self, op_schema)
        finally:
            counter.paused -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = paused
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _module_path(tracker) -> Callable[[], str]:
    def path() -> str:
        parents = [p for p in tracker.parents if p != "Global"]
        name = max(parents, key=lambda p: p.count("."), default="")
        return f"{name} (backward)" if tracker.is_bw else name
    return path


def run_step(st: Step, n_devices: int) -> dict:
    """Run a built step once under the counter; the cell's analyses."""
    from torch.distributed._tools.mod_tracker import ModTracker

    args_b = tensor_bytes(*st.arg_trees)
    with st.fake:
        tracker = ModTracker()
        counter = _Counter(_module_path(tracker))
        for t in _leaves(st.arg_trees + st.state):
            counter.hold(_local(t))
        with _shape_propagation_paused(counter), tracker, counter:
            out = st.fn(*st.args)
        out_b = tensor_bytes(out)
        alias_b = tensor_bytes(*st.aliased(out))
        peak = counter.peak
    mem = {
        "argument_size_in_bytes": args_b,
        "output_size_in_bytes": out_b,
        "temp_size_in_bytes": max(peak - args_b - (out_b - alias_b), 0),
        "alias_size_in_bytes": alias_b,
    }
    return {
        "memory_analysis": mem,
        "cost_analysis": {"flops": float(counter.flops),
                          "bytes accessed": float(counter.bytes)},
        "collective_bytes": collective_bytes_by_kind(counter.records,
                                                     total_devices=n_devices),
        "peak_live_bytes": peak,
    }


def _compile_and_analyze(cfg: ArchConfig, shape: C.ShapeSpec, mesh) -> dict:
    t0 = time.time()
    res = run_step(build_step(cfg, shape, mesh), mesh.size())
    res.pop("peak_live_bytes")
    return {"trace_s": round(time.time() - t0, 1), **res}


def world_size(mesh_kind: str) -> int:
    return 512 if mesh_kind == "multi" else 256


def run_cell(arch_id: str, shape_name: str, mesh_kind: str) -> dict:
    cfg = C.get_arch(arch_id)
    shape = C.SHAPES[shape_name]
    reason = C.skip_reason(cfg, shape_name)
    if reason:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    init_fake_world(world_size(mesh_kind))
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    main = _compile_and_analyze(cfg, shape, mesh)
    toks = shape.global_batch * (shape.seq_len if shape.kind == "train" else 1)
    result = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok",
        "n_chips": world_size(mesh_kind),
        "tokens_per_step": toks,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "model_flops_per_step": cfg.model_flops_per_token() * toks
        * (3.0 if shape.kind == "train" else 1.0),
        **main,
    }
    print(f"[dryrun] {arch_id} x {shape_name} x {mesh_kind}: trace {main['trace_s']:.0f}s")
    print(f"  memory_analysis: {main['memory_analysis']}")
    print(f"  cost_analysis:   {main['cost_analysis']}")
    print(f"  collectives:     {main['collective_bytes']}")
    return result


def save_result(res: dict) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(
        RESULTS_DIR, f"{res['arch']}__{res['shape']}__{res['mesh']}.json"
    )
    with open(path, "w") as f:
        json.dump(res, f, indent=2)
    return path


def all_cells(meshes=("single", "multi")) -> list:
    return [(arch_id, shape_name, mesh_kind)
            for arch_id in C.ARCH_IDS
            for shape_name in C.SHAPES
            for mesh_kind in meshes]


def _run_all(meshes, jobs: int, force: bool) -> int:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    todo = []
    for arch_id, shape_name, mesh_kind in all_cells(meshes):
        path = os.path.join(
            RESULTS_DIR, f"{arch_id}__{shape_name}__{mesh_kind}.json"
        )
        if not force and os.path.exists(path):
            continue
        todo.append((arch_id, shape_name, mesh_kind))
    print(f"[dryrun] {len(todo)} cells to run, {jobs} jobs")
    procs: list = []
    failed = []
    while todo or procs:
        while todo and len(procs) < jobs:
            a, s, m = todo.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--mesh", m]
            procs.append(((a, s, m), subprocess.Popen(cmd)))
            print(f"[dryrun] started {a} x {s} x {m}")
        time.sleep(2)
        still = []
        for cell, p in procs:
            if p.poll() is None:
                still.append((cell, p))
            elif p.returncode != 0:
                failed.append(cell)
                print(f"[dryrun] FAILED {cell}")
            else:
                print(f"[dryrun] done {cell}")
        procs = still
    if failed:
        print(f"[dryrun] {len(failed)} failures: {failed}")
        return 1
    print("[dryrun] all cells complete")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=C.ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(C.SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for cell in all_cells():
            print(*cell)
        return 0
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        return _run_all(meshes, args.jobs, args.force)
    if not (args.arch and args.shape):
        ap.error("--arch/--shape required without --all")
    for m in meshes:
        res = run_cell(args.arch, args.shape, m)
        save_result(res)
        if res["status"] not in ("ok", "skipped"):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
