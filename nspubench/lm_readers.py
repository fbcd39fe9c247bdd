"""Arithmetic the LM cells' per-layer readers share.  Each returns None
where the run has nothing for it to read: no ``lm`` work (another cell),
no program span (a program without the tracer's LM spans), no device trace
or an unknown card."""
from __future__ import annotations

from nspubench import readers
from nspubench.roofline import flash_attention as flash_roof


def _lm(ctx):
    return ctx.work.get("lm") if isinstance(ctx.work, dict) else None


def span_ms(ctx, name: str):
    snap = ctx.work.get("obs") if _lm(ctx) else None
    if not snap:
        return None
    d = [s[2] - s[1] for s in snap.get("spans", ()) if s[0] == name and s[2] is not None]
    return 1e3 * sum(d) / len(d) if d else None


def flash_roofline_pct(ctx):
    lm = _lm(ctx)
    if lm is None or ctx.trace is None:
        return None
    return flash_roof.share_pct(ctx.counts.get("flash_attention", []), ctx.trace.kernels,
                                lm["card"])


def mfu_pct(ctx):
    lm = _lm(ctx)
    pk = flash_roof.PEAKS.get(lm["card"]) if lm else None
    if pk is None or not ctx.counts.get("ops") or ctx.work["window_s"] <= 0:
        return None
    return 100.0 * ctx.counts["ops"] / (ctx.work["window_s"] * pk["bf16_ops_per_s"])


def idle_pct(ctx):
    return readers.idle_pct(ctx) if _lm(ctx) else None


def kernels_per_decoded_token(ctx):
    if not _lm(ctx) or ctx.trace is None or not ctx.work.get("tokens_decoded"):
        return None
    return ctx.trace.n_kernels / ctx.work["tokens_decoded"]
