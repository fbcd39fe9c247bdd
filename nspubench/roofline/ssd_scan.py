"""The Mamba2 SSD chunked scan kernel (csrc/ssd_scan.cu,
``tc::ssd_kernel<N, DH, Q>`` in bf16), one launch a mamba layer and
prefill.  An item is one launch: batch ``b``, positions ``L``, heads
``H``, groups ``G``, state ``N``, head dim ``dh``, chunk ``chunk``.
Bytes: x, B and C (bf16) and dt (f32) read once, y and the final state
written once (f32).  Operations: the plain chunked form's, 2 (N + dh) a
causal (query, key) pair of a chunk (C B^T, then mask * scores times x)
and 4 N dh a position (B^T x into the state, C S out of it), a head; the
kernel's bf16 parts of its f32 factors do more, and are not counted.  The
bound of a launch is the larger of its operations over the bf16 dense
tensor-core peak and its bytes over the HBM peak.

The peaks are kept here, not in ``peaks.json``: NVIDIA H100 SXM data
sheet, 989.4 TFLOP/s bf16 dense on the tensor cores and 3.35 TB/s HBM3,
at the 700 W power limit.
"""
from __future__ import annotations

from typing import Optional

KERNEL = "ssd_kernel"
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_ops_per_s": 989.4e12, "hbm_bytes_per_s": 3.35e12}}


def pairs(L: int, chunk: int) -> int:
    """Causal (query, key) pairs within the chunks of L positions."""
    full, last = divmod(L, chunk)
    return full * chunk * (chunk + 1) // 2 + last * (last + 1) // 2


def count(it: dict) -> tuple[int, int]:
    b, L, H, G, N, dh = it["b"], it["L"], it["H"], it["G"], it["N"], it["dh"]
    ops = b * H * (2 * (N + dh) * pairs(L, it["chunk"]) + 4 * N * dh * L)
    nbytes = (2 * b * L * (H * dh + 2 * G * N) + 4 * b * L * H + 4 * b * L * H * dh
              + 4 * b * H * N * dh)
    return ops, nbytes


def bound_s(items: list, pk: dict) -> float:
    total = 0.0
    for it in items:
        ops, nbytes = count(it)
        total += max(ops / pk["bf16_ops_per_s"], nbytes / pk["hbm_bytes_per_s"])
    return total


def share_pct(items: list, kernels: dict, kind: Optional[str]) -> Optional[float]:
    """The launches' bound over the device time of the kernels whose name
    holds ``KERNEL``, in %; None where the trace has no such kernel,
    nothing was counted or the card is unknown."""
    pk = PEAKS.get(kind or "")
    if pk is None or not items:
        return None
    seconds = sum(v[0] for k, v in kernels.items() if KERNEL in k)
    if seconds <= 0:
        return None
    return 100.0 * bound_s(items, pk) / seconds
