"""Arithmetic the Kanana-2 (MLA) cell's per-layer readers add to
``lm_readers``'.  Each returns None where the run has nothing for it to
read: no ``lm`` work (another cell), no MLA span or MoE counter (a
program without them),
no device trace or an unknown card."""
from __future__ import annotations

from nspubench import lm_readers
from nspubench.roofline import flash_mla as mla_roof


def mla_prefill_ms_per_batch(ctx):
    """Device time of a prefill's ``lm.mla`` spans (their CUDA events),
    summed, over the prefills, ms."""
    snap = ctx.work.get("obs") if lm_readers._lm(ctx) else None
    if not snap or not snap.get("device_ms"):
        return None
    spans = snap.get("spans", ())
    ms = snap["device_ms"]
    mla = [ms[i] for i, s in enumerate(spans)
           if s and s[0] == "lm.mla" and len(s[4]) > 1 and s[4][1] == "prefill" and i in ms]
    prefills = sum(1 for s in spans if s and s[0] == "lm.prefill" and s[2] is not None)
    return sum(mla) / prefills if mla and prefills else None


def experts_hit_pct(ctx):
    """Routed experts with at least one assignment, over the routed experts
    of every MoE block run (prefills and decode steps), %."""
    lm = lm_readers._lm(ctx)
    snap = ctx.work.get("obs") if lm else None
    c = snap.get("counters", {}) if snap else {}
    blocks = c.get("lm.moe_blocks")
    if not blocks or "lm.moe_experts_hit" not in c:
        return None
    return 100.0 * c["lm.moe_experts_hit"] / (blocks * lm["conf"]["n_routed_experts"])


def flash_mla_roofline_pct(ctx):
    lm = lm_readers._lm(ctx)
    if lm is None or ctx.trace is None:
        return None
    return mla_roof.share_pct(ctx.counts.get("flash_mla", []), ctx.trace.kernels, lm["card"])
