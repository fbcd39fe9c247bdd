"""Port parity, part 19: the sharding rules (``distributed/sharding.py``,
``train_loop._opt_specs``) against the JAX package's.

Every spec is compared exactly, path by path: parameters of all ten
archs at full width (the port's layer-stacked ``param_tree`` of a model
on ``meta`` against ``jax.eval_shape`` of ``init_params``) on both
production meshes, with and without the FSDP factor; the batch specs of
every applicable (arch, shape) cell's inputs; the cache specs of every
arch's cache; the optimizer-state specs of AdamW, Adafactor and EF-int8.
``to_placements`` is held against the local shapes ``distribute_tensor``
gives on a fake process group.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.distributed import sharding as jsharding
from repro.distributed import train_loop as jtrain_loop
from repro.distributed.optimizer import Schedule as JSchedule
from repro.distributed.optimizer import make_optimizer as jmake_optimizer
from repro.models import transformer as JT
import repro_torch.configs as C
from repro_torch.distributed import optimizer as topt
from repro_torch.distributed import sharding, train_loop
from repro_torch.launch import dryrun
from repro_torch.models import transformer as T


class SingleMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class MultiMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"single": SingleMesh(), "multi": MultiMesh()}


def _canon(spec) -> tuple:
    """A spec as ``PartitionSpec`` canonicalises it: a one-axis tuple is
    that axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _jax_flat(tree) -> dict:
    """{path: spec tuple} of a JAX spec tree (PartitionSpec leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(str(k.key) for k in path): _canon(spec) for path, spec in flat}


def _port_flat(tree, path=(), canon=True) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, path + (str(k),), canon))
        return out
    return {path: _canon(tree) if canon and isinstance(tree, tuple) else tree}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(lambda: JT.init_params(jax.random.key(0), JC.get_arch(arch)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return dryrun._param_shapes(C.get_arch(arch))


@pytest.mark.parametrize("serve", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_param_specs_equal_jax(arch, mesh, serve):
    m = MESHES[mesh]
    want = _jax_flat(jsharding.param_specs(_jax_params(arch), m, serve=serve))
    got = _port_flat(sharding.param_specs(_port_params(arch), m, serve=serve))
    assert got == want
    # the trees' leaves agree too, so the rules saw the JAX shapes
    jshapes = {tuple(str(k.key) for k in p): tuple(l.shape) for p, l in
               jax.tree_util.tree_flatten_with_path(_jax_params(arch))[0]}
    assert {p: tuple(t.shape) for p, t in _port_flat(_port_params(arch)).items()} == jshapes


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharding_rules_cover_every_param(mesh):
    """Every leaf of every full arch gets a spec with one entry per dim,
    only the mesh's axis names, and every sharded dim divides."""
    m = MESHES[mesh]
    for arch in C.ARCH_IDS:
        params = _port_params(arch)
        specs = _port_flat(sharding.param_specs(params, m))
        for path, leaf in _port_flat(params).items():
            spec = specs[path]
            assert len(spec) == leaf.ndim, (arch, path, spec, leaf.shape)
            for dim, names in zip(leaf.shape, spec):
                names = () if names is None else names if isinstance(names, tuple) else (names,)
                prod = 1
                for nm in names:
                    assert nm in m.axis_names
                    prod *= m.shape[nm]
                assert dim % prod == 0, (arch, path, spec, leaf.shape)
            assert sharding.local_shape(leaf.shape, spec, m)


def _cells():
    return [(a, s) for a in C.ARCH_IDS for s in C.SHAPES
            if C.applicable(C.get_arch(a), s)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", _cells())
def test_batch_specs_equal_jax(arch, shape, mesh):
    m = MESHES[mesh]
    want = _jax_flat(jsharding.batch_specs(
        JC.input_specs(JC.get_arch(arch), JC.SHAPES[shape]), m))
    got = _port_flat(sharding.batch_specs(
        C.input_specs(C.get_arch(arch), C.SHAPES[shape]), m))
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_cache_specs_equal_jax(arch, mesh):
    m = MESHES[mesh]
    cfg, jcfg = C.get_arch(arch), JC.get_arch(arch)
    shape = C.SHAPES["long_500k" if C.applicable(cfg, "long_500k") else "decode_32k"]
    enc = cfg.enc_seq if cfg.family == "audio" else 0
    jcache = jax.eval_shape(lambda: JT.init_cache(
        jcfg, shape.global_batch, shape.seq_len, enc_len=enc))
    cache = dryrun._cache_shapes(cfg, shape.global_batch, shape.seq_len)
    assert _port_flat(sharding.cache_specs(cache, m)) == _jax_flat(
        jsharding.cache_specs(jcache, m))
    assert set(_port_flat(cache)) == set(_jax_flat(jsharding.cache_specs(jcache, m)))


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "adamw+ef", "adafactor+ef"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "kimi-k2-1t-a32b", "zamba2-7b"])
def test_opt_specs_equal_jax(arch, opt):
    name, compress = opt.split("+")[0], opt.endswith("+ef")
    m = MESHES["single"]
    jp = _jax_params(arch)
    jo = jmake_optimizer(name, JSchedule(), compress=compress)
    jstate = jax.eval_shape(lambda: jo.init(jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), jp)))
    want = _jax_flat(jtrain_loop._opt_specs(jstate, jp, m))
    p = _port_params(arch)
    state = topt.make_optimizer(name, topt.Schedule(), compress=compress).init(p)
    got = _port_flat(train_loop._opt_specs(state, p, m))
    assert got == want
    shapes = {k: tuple(v.shape) for k, v in _port_flat(state).items()}
    jshapes = {tuple(str(k.key) for k in path): tuple(leaf.shape) for path, leaf in
               jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert shapes == jshapes


def test_adafactor_factored_specs_keep_the_reference_quirk():
    """A factored second moment takes the rule of its parameter truncated
    to its own ndim: the rule of wq [L, D, Hq dh] is (None, dp, model),
    so vr [L, D] gets (None, dp) and vc [L, Hq dh] (None, dp), which
    shards the head columns over the dp axes."""
    m = MESHES["single"]
    p = _port_params("granite-3-8b")
    state = topt.make_optimizer("adafactor", topt.Schedule()).init(p)
    specs = train_loop._opt_specs(state, p, m)
    assert specs["vr"]["blocks"]["attn"]["wq"] == (None, ("data",))
    assert specs["vc"]["blocks"]["attn"]["wq"] == (None, ("data",))
    assert specs["m"]["blocks"]["attn"]["wq"] == (None, ("data",), "model")
    assert specs["step"] == ()


def test_meshes_need_a_process_group_of_their_size():
    """Without a process group of the mesh's size a mesh is refused, never
    shrunk (this file's fake group, if alive, has 8 ranks)."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="15 ranks"):
        make_mesh((3, 5), ("data", "model"))


@pytest.fixture(scope="module")
def fake_world():
    import torch.distributed as dist

    dryrun.init_fake_world(8)
    yield
    T.set_mesh(None)
    dist.destroy_process_group()


@pytest.mark.parametrize("shape,axes,spec,tensor_shape", [
    ((2, 4), ("data", "model"), (("data",), "model"), (8, 12)),
    ((2, 4), ("data", "model"), ("model", ("data",)), (16, 6)),
    ((2, 4), ("data", "model"), (None, ("data",), "model"), (3, 10, 8)),
    ((2, 4), ("data", "model"), (("data", "model"),), (24,)),
    ((2, 4), ("data", "model"), (None, None), (5, 7)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), None, "model"), (8, 3, 6)),
    ((2, 2, 2), ("pod", "data", "model"), ("model", ("pod", "data")), (4, 12)),
    ((2, 2, 2), ("pod", "data", "model"), (None, ("pod",), None, "model"), (2, 6, 5, 4)),
])
def test_to_placements_gives_distribute_tensors_local_shapes(fake_world, shape, axes,
                                                             spec, tensor_shape):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, axes)
    sizes = dict(zip(axes, shape))

    class Named:
        axis_names = axes
        shape = sizes

    pl = sharding.to_placements(spec, mesh)
    assert pl == sharding.to_placements(spec, Named())
    d = distribute_tensor(torch.arange(torch.Size(tensor_shape).numel()).reshape(tensor_shape),
                          mesh, pl, src_data_rank=None)
    assert tuple(d.to_local().shape) == sharding.local_shape(tensor_shape, spec, Named())
    # rank 0 holds the first block of every sharded dim
    first = tuple(slice(0, n) for n in d.to_local().shape)
    assert torch.equal(d.to_local(), torch.arange(torch.Size(tensor_shape).numel())
                       .reshape(tensor_shape)[first])
    tree = sharding.to_shardings({"a": torch.zeros(tensor_shape), "len": 3}, {"a": spec}, mesh)
    assert tree["len"] == 3 and tuple(tree["a"].placements) == pl
    assert sharding.local_bytes({"a": torch.zeros(tensor_shape)}, {"a": spec}, Named()) == \
        tree["a"].to_local().numel() * 4


