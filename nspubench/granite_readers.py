"""Arithmetic the Granite 4.0-H cell's per-layer readers add to
``lm_readers``'.  Each returns None where the run has nothing for it to
read: no ``lm`` work (another cell), no MoE span or counter (a program
without them), no device trace or an unknown card."""
from __future__ import annotations

from nspubench import lm_readers
from nspubench.roofline import ssd_scan as ssd_roof


def _snap(ctx):
    return ctx.work.get("obs") if lm_readers._lm(ctx) else None


def moe_prefill_ms_per_batch(ctx):
    """Device time of a prefill's ``lm.moe`` spans (their CUDA events),
    summed, over the prefills, ms."""
    snap = _snap(ctx)
    if not snap or not snap.get("device_ms"):
        return None
    spans = snap.get("spans", ())
    ms = snap["device_ms"]
    moe = [ms[i] for i, s in enumerate(spans)
           if s and s[0] == "lm.moe" and len(s[4]) > 1 and s[4][1] == "prefill" and i in ms]
    prefills = sum(1 for s in spans if s and s[0] == "lm.prefill" and s[2] is not None)
    return sum(moe) / prefills if moe and prefills else None


def experts_hit_pct(ctx):
    """Experts with at least one assignment, over the experts of every MoE
    block run (prefills and decode steps), %."""
    snap = _snap(ctx)
    c = snap.get("counters", {}) if snap else {}
    blocks = c.get("lm.moe_blocks")
    if not blocks or "lm.moe_experts_hit" not in c:
        return None
    return 100.0 * c["lm.moe_experts_hit"] / (blocks * ctx.work["lm"]["conf"]["num_local_experts"])


def ssd_roofline_pct(ctx):
    lm = lm_readers._lm(ctx)
    if lm is None or ctx.trace is None:
        return None
    return ssd_roof.share_pct(ctx.counts.get("ssd_scan", []), ctx.trace.kernels, lm["card"])
