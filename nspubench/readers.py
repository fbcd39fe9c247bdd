"""Arithmetic the per-layer metric readers share.  Each reader returns
None where its cell's run has nothing for it to read."""
from __future__ import annotations

from nspubench import roofline
from nspubench.generators import quantile


def per_design_ms(ctx, span: str, self_time: bool) -> float | None:
    if ctx.spans is None or not ctx.spans.count(span) or not ctx.work.get("designs"):
        return None
    t = ctx.spans.self_total(span) if self_time else ctx.spans.total(span)
    return 1e3 * t / ctx.work["designs"]


def per_call_ms(ctx, span: str) -> float | None:
    if ctx.spans is None or not ctx.spans.count(span):
        return None
    return 1e3 * ctx.spans.total(span) / ctx.spans.count(span)


def idle_pct(ctx) -> float | None:
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def kernels_per(ctx, unit: str) -> float | None:
    if ctx.trace is None or not ctx.work.get(unit):
        return None
    return ctx.trace.n_kernels / ctx.work[unit]


def mfu_window(ctx) -> float | None:
    """Counted operations of the window's work over the window at the
    float32 peak, in %."""
    if ctx.peaks is None or not ctx.counts.get("ops"):
        return None
    return 100.0 * ctx.counts["ops"] / (ctx.work["window_s"] * ctx.peaks["f32_ops_per_s"])


def mfu_serving(ctx) -> float | None:
    """Counted operations of the window's batches and re-fits over the
    summed time of their spans at the float32 peak, in %."""
    if ctx.peaks is None or ctx.spans is None or not ctx.counts.get("ops"):
        return None
    busy = ctx.spans.total("assign") + ctx.spans.total("fit")
    if busy <= 0:
        return None
    return 100.0 * ctx.counts["ops"] / (busy * ctx.peaks["f32_ops_per_s"])


def service_self_us(ctx) -> float | None:
    """Host time of the service around its device entry points per
    request: the submit and flush spans less the assignment and re-fit
    spans inside them."""
    if ctx.spans is None or not ctx.spans.count("submit") or not ctx.work.get("requests"):
        return None
    t = ctx.spans.self_total("submit") + ctx.spans.self_total("flush")
    return 1e6 * t / ctx.work["requests"]


def p95_ms(ctx, key: str) -> float | None:
    v = ctx.work.get(key)
    return 1e3 * quantile(v, 0.95) if v else None


def roofline_pct(ctx, kernel: str) -> float | None:
    if ctx.trace is None:
        return None
    return roofline.share_pct(kernel, ctx.counts.get(kernel, []), ctx.trace.kernels, ctx.peaks)
