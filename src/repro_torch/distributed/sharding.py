"""Sharding rules: parameter, activation and cache layouts on the
production mesh (pod, data, model).

Port of the JAX package's ``distributed/sharding.py``, rule for rule:

  * TP over ``model``: attention heads / FFN hidden / expert dim / vocab.
  * EP over ``model``: MoE expert dim (E % model_size == 0 for all archs).
  * FSDP over (pod, data): the non-TP dim of every large matrix.
  * DP over (pod, data): the global batch.
  * SP over ``model``: decode KV caches shard the *sequence* dim (kv-head
    counts are below the model-axis size for several archs, sequence is
    not).

Specs are derived from parameter *path names*, so they apply to the
layer-stacked tree ``transformer.param_tree(model)`` gives, whose leaves
are the JAX package's.  A spec is a tuple with one entry per tensor
dimension, as a ``PartitionSpec`` is: ``None``, an axis name, or a tuple
of axis names.  The mesh is anything with axis names and a shape: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``, a
tuple ``shape``), or a stand-in with ``axis_names`` and a ``shape``
mapping each name to its size.  ``to_placements`` turns a spec into
DTensor placements and ``to_shardings`` a tree into ``DTensor``s.
"""
from __future__ import annotations

from typing import Optional

import torch

_STACKED = ("blocks", "enc_blocks", "cross_blocks")


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def axis_size(mesh, axis: str) -> int:
    shape = mesh.shape
    if isinstance(shape, dict):
        return int(shape[axis])
    return int(shape[axis_names(mesh).index(axis)])


def dp_axes(mesh) -> tuple:
    return tuple(a for a in axis_names(mesh) if a != "model")


def fit_axes(size: int, mesh, axes: tuple) -> Optional[tuple]:
    """Largest prefix of ``axes`` whose product divides ``size`` (None if
    none fits): small batches (long_500k's batch 1) fall back to
    replication instead of an invalid sharding."""
    best: Optional[tuple] = None
    prod = 1
    for i, a in enumerate(axes):
        prod *= axis_size(mesh, a)
        if size % prod == 0:
            best = tuple(axes[: i + 1])
    return best


def _leaf_spec(names: list, ndim: int, fsdp) -> tuple:
    """The rule of one parameter leaf from its path names, for the
    per-layer shape; a leading layer-stack dim gets None."""
    name = names[-1]
    stacked = any(n in _STACKED for n in names)
    base: tuple
    if name == "embed":
        base = ("model", fsdp)  # vocab x d_model
    elif name == "lm_head":
        base = (fsdp, "model")
    elif name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj"):
        if names[-2] in ("moe",) or ndim - (1 if stacked else 0) == 3:
            base = ("model", fsdp, None)  # experts [E, D, F]
        else:
            base = (fsdp, "model")
    elif name in ("wo", "w_down", "out_proj"):
        if names[-2] in ("moe",) or ndim - (1 if stacked else 0) == 3:
            base = ("model", None, fsdp)  # [E, F, D]
        else:
            base = ("model", fsdp)
    elif name == "router":
        base = (None, None)
    elif name == "conv_w":
        base = (None, "model")
    elif name in ("a_q",):
        base = (None, fsdp, None)  # lora [apps, D, r]
    elif name in ("b_q",):
        base = (None, None, "model")  # lora [apps, r, Hq]
    else:
        # norms, biases, scalars: replicate
        return tuple(None for _ in range(ndim))
    if stacked:
        base = (None,) + base
    if len(base) < ndim:
        base = base + tuple(None for _ in range(ndim - len(base)))
    return tuple(base[:ndim])


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(list(path), tree)


def _ndim(leaf) -> int:
    return len(leaf.shape) if hasattr(leaf, "shape") else 0


def param_specs(params_tree, mesh, serve: bool = False):
    """Spec tree for a (layer-stacked) parameter tree.

    ``serve=True`` drops the FSDP factor (parameters replicate over the dp
    axes, TP/EP over model only): inference has no optimizer state to
    amortize, and the per-layer FSDP weight all-gathers would dominate the
    collective term.
    """
    fsdp = None if serve else dp_axes(mesh)
    return _map_with_path(lambda names, leaf: _leaf_spec(names, _ndim(leaf), fsdp),
                          params_tree)


def batch_specs(batch_tree, mesh):
    """Inputs: batch dim over (pod, data), or the largest prefix that
    divides it; M-RoPE positions lead with a size-3 stream dim."""
    dp = dp_axes(mesh)

    def spec(names, leaf):
        nd = _ndim(leaf)
        if names and names[-1] == "positions":
            b = fit_axes(leaf.shape[1], mesh, dp)
            return (None, b) + (None,) * (nd - 2)
        b = fit_axes(leaf.shape[0], mesh, dp)
        return (b,) + (None,) * (nd - 1)

    return _map_with_path(spec, batch_tree)


def cache_specs(cache_tree, mesh):
    """Decode caches: KV tensors [L, B, S, H, dh] shard the *sequence* over
    model (SP) and batch over (pod, data); SSM states [L, B, H, N, dh]
    shard heads over model; conv states shard channels over model.  The
    port's ``'len'`` (a Python int) replicates, as the JAX scalar does."""
    dp = dp_axes(mesh)
    model = axis_size(mesh, "model")

    def spec(names, leaf):
        n = names[-1]
        if n == "len":
            return ()
        b = fit_axes(leaf.shape[1], mesh, dp)
        if n in ("k", "v", "xk", "xv"):  # [L, B, S, H, dh]
            s = "model" if leaf.shape[2] % model == 0 else None
            return (None, b, s, None, None)
        if n == "S":  # [L, B, H, N, dh]
            h = "model" if leaf.shape[2] % model == 0 else None
            return (None, b, h, None, None)
        if n == "conv":  # [L, B, K-1, C]
            c = "model" if leaf.shape[3] % model == 0 else None
            return (None, b, None, c)
        return (None,) * _ndim(leaf)

    return _map_with_path(spec, cache_tree)


def logits_spec(mesh) -> tuple:
    return (dp_axes(mesh), None, "model")


# ------------------------------------------------------------ DTensors
def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a spec: ``Shard(d)`` on each mesh dimension
    the spec names for tensor dimension ``d`` (in mesh order, so a dim
    over ("pod", "data") shards on both, pod outermost, as a
    ``PartitionSpec`` does), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        for a in _axes_of(entry):
            if a in where:
                raise ValueError(f"axis {a!r} used twice in {spec!r}")
            where[a] = d
    out = []
    for a in axis_names(mesh):
        out.append(Shard(where.pop(a)) if a in where else Replicate())
    if where:
        raise ValueError(f"spec {spec!r} names axes {tuple(where)} not in the mesh")
    return tuple(out)


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of one device's shard of a tensor of ``shape`` under
    ``spec`` (every sharded dim must divide)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _axes_of(entry):
            n = axis_size(mesh, a)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {a!r}")
            out[d] //= n
    return tuple(out)


def local_bytes(tree, spec_tree, mesh) -> int:
    """Bytes of one device's shards of every tensor leaf of ``tree``."""
    total = 0

    def add(names, leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            spec = _get(spec_tree, names)
            n = 1
            for s in local_shape(leaf.shape, spec, mesh):
                n *= s
            total += n * leaf.element_size()

    _map_with_path(add, tree)
    return total


def _get(tree, names):
    for n in names:
        tree = tree[n]
    return tree


def to_shardings(tree, spec_tree, mesh):
    """A tree of ``DTensor``s: each tensor leaf split by
    ``distribute_tensor`` along its spec, locally (``src_data_rank=None``:
    every rank already holds the whole tensor, no bytes move); other
    leaves (the cache's 'len') pass through."""
    from torch.distributed.tensor import distribute_tensor

    def one(names, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh, to_placements(_get(spec_tree, names), mesh),
                                 src_data_rank=None)

    return _map_with_path(one, tree)
