"""Operation and byte counts of the port's kernels, and their roofline.

Each kernel has a file of its own here, named after it: ``KERNEL`` (a
part of the kernel's name in the device trace) and ``count(item)`` ->
(operations, bytes) for one item of the work the reference counted for
it.  Counts come from the cell's shapes and generated inputs, through the
reference's replay, never from the program, and are the same whatever
implements the kernel: the fire in the slope form (one add where a live
synapse's ramp starts inside the window, one more where it also tops out
there, two a cycle for each live neuron's scan up to and including its
crossing), about ten operations a live synapse for an STDP update, each
input byte read once and each output byte written once.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent


def peaks(kind: str) -> Optional[dict]:
    """The data sheet's peaks of the card named ``kind``, or None."""
    return json.loads((HERE / "peaks.json").read_text()).get(kind)


def load(kernel: str):
    spec = importlib.util.spec_from_file_location(
        f"nspubench.roofline.{kernel}", HERE / f"{kernel}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fire_ops(up: int, down: int, cycles: int) -> int:
    return int(up) + int(down) + 2 * int(cycles)


def stdp_ops(p: int, q: int, volleys: int) -> int:
    return 10 * int(p) * int(q) * int(volleys)


def bound_s(kernel: str, items: list, pk: dict) -> float:
    """Least time the card could take for these items: per item the larger
    of operations over the float32 peak and bytes over the HBM peak."""
    mod = load(kernel)
    total = 0.0
    for it in items:
        ops, nbytes = mod.count(it)
        total += max(ops / pk["f32_ops_per_s"], nbytes / pk["hbm_bytes_per_s"])
    return total


def share_pct(kernel: str, items: list, kernels: dict, pk: Optional[dict]) -> Optional[float]:
    """The kernel's share of its roofline in % over the traced window:
    the items' bound over the device time of the kernels whose name holds
    ``KERNEL``.  None where the trace has no such kernel, nothing was
    counted, or the card's peaks are unknown."""
    if pk is None or not items:
        return None
    name = load(kernel).KERNEL
    seconds = sum(v[0] for k, v in kernels.items() if name in k)
    if seconds <= 0:
        return None
    return 100.0 * bound_s(kernel, items, pk) / seconds
