"""Collective byte accounting for the roofline.

The port's counterpart of the JAX package's ``launch/hlo.py``, which
parses the compiled HLO text.  PyTorch compiles no SPMD program, so there
is no HLO here: ``CollectiveRecorder`` records, while a step runs on
``DTensor``s, each ``_c10d_functional`` collective that DTensor issues
(its kind, the bytes of its result, its group size and the module it ran
under), and ``collective_bytes_by_kind`` applies the same per-device
wire-byte formulas, ring algorithms over a group of N participants (R the
result's bytes):

  all-gather          R * (N-1)/N        (result is the gathered buffer)
  all-reduce          R * 2(N-1)/N       (reduce-scatter + all-gather phases)
  reduce-scatter      R * (N-1)          (operand = N*R, each device sends
                                          (N-1)/N of it)
  all-to-all          R * (N-1)/N
  collective-permute  R                  (point-to-point)

A collective counts once, never its ``wait_tensor`` (the JAX parser skips
an async pair's '-done' for the same reason).  The eager step runs every
layer, so nothing is counted once for a whole loop.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# _c10d_functional op -> kind; the rest of that namespace (wait_tensor)
# is not a collective
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


@dataclasses.dataclass
class Collective:
    kind: str
    result_bytes: int
    group_size: int
    shape: str
    module: str = ""


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a for a in args if isinstance(a, str)]  # the group's name comes last
    return _resolve_process_group(names[-1]).size() if names else 1


def collective_of(func, args, out, module: str = "") -> "Collective | None":
    """The record of one op if it is a ``_c10d_functional`` collective."""
    ns, _, name = str(func.overloadpacket).partition(".")
    kind = _KIND.get(name) if ns == "_c10d_functional" else None
    if kind is None:
        return None
    shapes = [f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}" for t in _tensors(out)]
    return Collective(kind, _nbytes(out), _group_size(args),
                      ",".join(shapes)[:60], module)


class CollectiveRecorder(TorchDispatchMode):
    """Records the collectives of the ops run under it.  On ``DTensor``
    arguments it steps aside (``NotImplemented``), so DTensor desugars the
    op into its local ops and collectives first and the recorder sees
    those.  ``module`` is a callable giving the current module path."""

    def __init__(self, module=lambda: ""):
        super().__init__()
        self.records: list[Collective] = []
        self.module = module

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        rec = collective_of(func, args, out, self.module())
        if rec is not None:
            self.records.append(rec)
        return out


def wire_bytes(kind: str, r: int, n: int) -> int:
    if kind == "all-gather":
        return r * (n - 1) // max(n, 1)
    if kind == "all-reduce":
        return 2 * r * (n - 1) // max(n, 1)
    if kind == "reduce-scatter":
        return r * (n - 1)
    if kind == "all-to-all":
        return r * (n - 1) // max(n, 1)
    return r  # collective-permute


def collective_bytes_by_kind(records, total_devices: int = 1) -> dict:
    """Per-device collective wire bytes by kind from recorded collectives
    (a group size of 0 stands for all ``total_devices``).  Returns
    {kind: bytes, 'total': ..., 'counts': {...}, 'largest': [8 entries]},
    the JAX package's dict."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    largest: list = []
    for rec in records:
        n = rec.group_size or max(total_devices, 1)
        b = wire_bytes(rec.kind, rec.result_bytes, n)
        out[rec.kind] += b
        counts[rec.kind] += 1
        largest.append((b, rec.kind, rec.shape, rec.module))
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = counts
    largest.sort(key=lambda t: -t[0])
    out["largest"] = [
        {"bytes": b, "kind": k, "shape": sh, "op": op}
        for b, k, sh, op in largest[:8]
    ]
    return out
