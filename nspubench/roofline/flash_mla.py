"""The flash attention kernel (csrc/flash_attention.cu) at MLA's split head
dims, the bf16 tensor-core instantiation DeepSeek-V3's expanded prefill
launches (``tc::flash_mla_kernel<192, 128>``: Q and K at 192, V and O at
128), one launch a layer and prompt row.  An item is one launch: batch
``b``, query rows ``sq``, key rows ``skv``, heads ``h``, Q's and K's head
dim ``dqk``, V's and O's ``dv``, ``causal``.  Operations: 2 dqk + 2 dv a
query-key pair the kernel must score (Q K^T, then P V), the pairs a causal
prefill's triangle (query i sees keys 0..i, with ``skv == sq``) or
sq x skv; bytes: Q and K at dqk, V and O at dv, each read or written once,
in bf16.  The bound of a launch is the larger of its operations over the
bf16 dense tensor-core peak and its bytes over the HBM peak.

The peaks are kept here, not in ``peaks.json``: NVIDIA H100 SXM data
sheet, 989.4 TFLOP/s bf16 dense on the tensor cores and 3.35 TB/s HBM3,
at the 700 W power limit.
"""
from __future__ import annotations

from typing import Optional

KERNEL = "flash_mla_kernel<192, 128>"
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_ops_per_s": 989.4e12, "hbm_bytes_per_s": 3.35e12}}


def pairs(it: dict) -> int:
    """Query-key pairs a (batch, head) scores: query row i sees keys 0..i
    when causal (the kernel's mask ``key <= row``), every key otherwise."""
    sq, skv = it["sq"], it["skv"]
    if not it["causal"]:
        return sq * skv
    if sq == skv:
        return sq * (sq + 1) // 2
    return sum(min(i + 1, skv) for i in range(sq))


def count(it: dict) -> tuple[int, int]:
    bh, dqk, dv = it["b"] * it["h"], it["dqk"], it["dv"]
    ops = (2 * dqk + 2 * dv) * pairs(it) * bh
    nbytes = 2 * bh * ((it["sq"] + it["skv"]) * dqk + (it["skv"] + it["sq"]) * dv)
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
