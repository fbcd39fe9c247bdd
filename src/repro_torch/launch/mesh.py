"""Production mesh construction.

FUNCTIONS (not module-level constants), so importing this module touches
no process group; callers decide when a mesh exists.

The shapes are the JAX package's production meshes: (16, 16) over
("data", "model"), 256 devices, and (2, 16, 16) over ("pod", "data",
"model"), 512 devices.  Axis semantics:
  pod   — data parallelism across pods,
  data  — FSDP + data parallelism within a pod,
  model — TP / EP / SP.

Each builds a ``torch.distributed`` ``DeviceMesh`` over the default
process group, whose world size must be the product of the shape (the
dry run initialises a fake group of that size, ``launch/dryrun.py``); a
mesh is never shrunk to fit a smaller group.
"""
from __future__ import annotations

import math


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: tuple, axes: tuple):
    """Any mesh: ``shape`` over the axis names ``axes``, of CPU devices
    (the dry run's tensors are fake CPU tensors; the gloo checks' real
    ones)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {n} ranks; none is initialised")
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {n} ranks, this one has "
            f"{dist.get_world_size()}")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))
