"""Simulation-backend registry and the port's one lowering probe.

* **Registry**: three named backends sharing one contract, the same names
  as the JAX package's so that ``mode=`` means the same thing in both:
    'event'  — closed-form event-driven solver (exact for RNL/SNL).
    'cycle'  — cycle-accurate loop (bit-identical to generated RTL,
               required for LIF).
    'pallas' — the fused column step (``kernels/fused_column.py``): RNL
               fire + k-WTA + expected STDP in one kernel launch per
               volley.  The name is the JAX package's; here it runs the
               CUDA kernels.
  Each backend provides ``fire`` (batched post-WTA forward) and ``fit``
  (online STDP over epochs x volleys).

* **Lowering**: ``lowering(t)`` is the one probe.  CUDA tensors on an
  sm_90 card lower to the hand-written kernels (``'cuda'``), CPU tensors
  to their plain PyTorch versions (``'reference'``).  A CUDA tensor on any
  other card raises: the kernels are built for sm_90a only.

* **Padded-scan policy**: one policy, the JAX package's constants
  (``roofline/costmodel.py``): ``volley_block`` / ``execution_plan``,
  ``assign_lowering``, the degradation ladder (``lowering_ladder``,
  ``cycle_exact``) and the envelope bucket policy (``envelope_buckets``).
  The sweep and network layers call ``fused_column.fit_scan_padded`` /
  ``assign_padded`` directly, with the ``v_blk`` of their plan.

* **Resolution**: ``resolve(mode, cfg, training=...)`` maps the public
  ``mode`` knob to a registry name; 'auto' keeps the paper's hybrid
  forward (event where exact, cycle for LIF) and trains on the fused path
  whenever the config fits its contract.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import neuron, stdp, wta
from repro_torch.core.types import ColumnConfig, TIME_DTYPE
from repro_torch.kernels import fused_column
from repro_torch.roofline import costmodel


# ----------------------------------------------------------- central policy
def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    card.  With no card and no explicit request it raises; it never falls
    back to the CPU quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def lowering(t: torch.Tensor) -> str:
    """'cuda' for a CUDA tensor on an sm_90 card, 'reference' for a CPU
    tensor.  The ONLY lowering probe."""
    if t.device.type == "cpu":
        return "reference"
    if t.device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(t.device)
        if major == 9:
            return "cuda"
        raise RuntimeError(
            f"the port's CUDA kernels are built for sm_90a; "
            f"{torch.cuda.get_device_name(t.device)} is sm_{major}{minor}"
        )
    raise RuntimeError(f"unsupported device {t.device}")


def padded_lowering(response: str, t: torch.Tensor) -> str:
    """Response-aware lowering of the fused paths: the CUDA kernel fires
    RNL only; SNL lowers to the plain body of the same algebra on every
    device (a lowering choice, not a semantic switch)."""
    low = lowering(t)
    if response in fused_column.fire_responses(low):
        return low
    return "reference"


def volley_block(
    lowering: str, n_volleys: int, d: Optional[int] = None
) -> int:
    """Volleys the padded training scan folds per block, the constants
    policy of the JAX package: 32 for the kernel lowering (one launch per
    block), 8 for 'reference', capped at ``max(2, 2 d)`` when the design
    axis ``d`` is known, and never more than the stream.  Results do not
    depend on it."""
    return costmodel.const_v_blk(lowering, n_volleys, d)


def execution_plan(
    kind: str, lowering: str, d: int, n_volleys: int
) -> costmodel.ExecutionPlan:
    """The ``ExecutionPlan`` of a padded scan of ``d`` designs over
    ``n_volleys`` volleys: the constants plan.  A plan changes the
    blocking only, never a result."""
    return costmodel.constants_plan(kind, lowering, d, n_volleys)


def assign_lowering(response: str, w: torch.Tensor) -> str:
    """Lowering of the batched assignment pass, given the trained weights.

    The ``'cuda'`` lowering fires the integer weight grid
    (``fire_block``), the reference lowering the float weights as they
    are (on the card the ``fire_float`` kernel, on the CPU its plain
    version).  So the grid kernel is a pure lowering choice only when the
    weights already sit on the grid (after integer-mu, unstabilized
    training from integer init); off-grid weights take the reference
    lowering on every device.
    """
    low = padded_lowering(response, w)
    if low == "reference":
        return low
    return low if bool(torch.all(w == torch.round(w))) else "reference"


# ------------------------------------------------- lowering degradation
# The fused-scan lowerings.  A failing evaluation never changes device:
# on the card a kernel that does not build or launch raises, or has its
# design quarantined, and never turns into plain PyTorch on the card, so
# 'cuda' is a ladder of one rung.  'reference' (the plain versions, on
# the CPU, or for SNL on any device) has the 'cycle' solver below it
# where that is provably bit-identical (``cycle_exact``).  The JAX
# package's 'interpret' rung has no counterpart (a CUDA kernel has no
# interpreter).
LOWERING_LADDER = ("cuda", "reference")

# Bound on attempts per evaluation: the fused rung plus the optional
# 'cycle' rung.  A deterministic scan repeats its failure, so no rung is
# tried twice.
MAX_EVAL_RETRIES = 2


def lowering_ladder(start: str, cycle_exact: bool = False) -> tuple[str, ...]:
    """Rungs a fused evaluation starting at ``start`` may try
    (``cluster_time_series_many(on_error='isolate')``): ``start`` itself,
    then, below 'reference' only, the 'cycle' solver when
    ``cycle_exact=True`` (legal only where ``cycle_exact(cfg, w0)``
    holds).  Every rung computes the same algebra, so a step down changes
    how a result is computed, never what it is."""
    if start == "cycle":
        return ("cycle",)
    if start not in LOWERING_LADDER:
        raise ValueError(
            f"unknown lowering: {start!r} (have {LOWERING_LADDER + ('cycle',)})"
        )
    if start == "cuda":
        return ("cuda",)
    return (start,) + (("cycle",) if cycle_exact else ())


# Degraded-mode backoff of the ONLINE re-fit (the serving analogue of
# MAX_EVAL_RETRIES): after the k-th consecutive re-fit failure a bucket
# sits out 2^(k-1) re-fit windows, capped so a long outage never pushes
# the retry horizon out indefinitely, and keeps serving from its
# last-good weights in the meantime.
REFIT_BACKOFF_CAP = 8


def refit_backoff(failures: int) -> int:
    """Re-fit windows to sit out after the ``failures``-th consecutive
    online re-fit failure (the streaming service's degraded mode)."""
    return int(min(2 ** (max(int(failures), 1) - 1), REFIT_BACKOFF_CAP))


def cycle_exact(cfg: ColumnConfig, w0) -> bool:
    """True iff the 'cycle' solver is bit-identical to the fused path for
    this design: integer STDP steps, no stabilizer, expected mode, and
    integral initial weights, so training never leaves the grid that the
    fused fire rounds to."""
    s = cfg.stdp
    if s.stabilizer != "none" or s.mode != "expected":
        return False
    if not all(
        float(mu).is_integer()
        for mu in (s.mu_capture, s.mu_backoff, s.mu_search)
    ):
        return False
    w0 = torch.as_tensor(w0)
    return bool(torch.all(w0 == torch.round(w0)))


# ----------------------------------------------------------- bucket policy
# A design joins a shared padding envelope only while padding inflates no
# member's per-volley fire volume (p * q * t_max) beyond this factor:
# padded work recurs every volley, so a small design must not ride a
# large design's envelope.
ENVELOPE_WASTE_CAP = costmodel.CONST_WASTE_CAP


def envelope_buckets(
    shapes: Sequence[tuple[int, int, int]],
    waste_cap: Optional[float] = None,
    max_bucket: Optional[int] = None,
) -> list[tuple[tuple[int, int, int], list[int]]]:
    """Pack (p, q, t_max) design shapes into shared padding envelopes.

    Greedy, largest fire volume first: a design joins the first bucket
    whose grown envelope (the elementwise max) keeps every member's
    volume within ``waste_cap`` (None: ``ENVELOPE_WASTE_CAP``) and that
    holds fewer than ``max_bucket`` designs (None: unbounded).  Returns
    ``[(envelope, member_indices), ...]``; every index lands in exactly
    one bucket.  Bucketing never changes a result: a design trains the
    same under any envelope that contains it.
    """
    if waste_cap is None:
        waste_cap = ENVELOPE_WASTE_CAP
    vols = [p * q * t for (p, q, t) in shapes]
    order = sorted(range(len(shapes)), key=lambda i: -vols[i])
    buckets: list[tuple[tuple[int, int, int], list[int]]] = []
    for i in order:
        p, q, t = shapes[i]
        for bi, (env, members) in enumerate(buckets):
            if max_bucket is not None and len(members) >= max_bucket:
                continue
            cand = (max(env[0], p), max(env[1], q), max(env[2], t))
            vol = cand[0] * cand[1] * cand[2]
            if all(vol <= waste_cap * vols[m] for m in members + [i]):
                buckets[bi] = (cand, members + [i])
                break
        else:
            buckets.append(((p, q, t), [i]))
    return buckets


# ------------------------------------------------------------- generic fit
def solver_volley_step(
    w: torch.Tensor,
    x_t: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: ColumnConfig,
    solver_mode: str,
    y_target: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One online-STDP step on the event/cycle solvers: fire -> WTA -> STDP.

    Returns (updated weights [p, q], post-WTA winner times [q]).
    """
    solver = (
        neuron.fire_times_event
        if solver_mode == "event"
        else neuron.fire_times_cycle
    )
    t = solver(x_t[None], w, cfg.neuron, cfg.t_max)[0]
    y, _ = wta.wta(
        t, cfg.wta, cfg.t_max,
        generator=generator if cfg.wta.tie_break == "random" else None,
    )
    teacher = y if y_target is None else y_target
    w2 = stdp.stdp_update(
        w, x_t, teacher, cfg.stdp, cfg.neuron.w_max, cfg.t_max,
        generator=generator if cfg.stdp.mode == "stochastic" else None,
    )
    return w2, y


def _solver_fit(
    params: dict,
    x: torch.Tensor,
    cfg: ColumnConfig,
    mode: str,
    epochs: int,
    generator: Optional[torch.Generator],
    trace: bool,
    y_target: Optional[torch.Tensor] = None,
):
    """Online STDP over epochs x volleys on the event/cycle solvers; the
    full config surface (LIF, stochastic STDP, random/all tie-breaks,
    supervised targets) that the fused step does not cover."""
    if generator is None:
        if cfg.wta.tie_break == "random":
            raise ValueError("tie_break='random' requires a torch.Generator")
        if cfg.stdp.mode == "stochastic":
            raise ValueError("stochastic STDP requires a torch.Generator")
    w = params["w"].to(torch.float32).clone()
    ys = []
    for _ in range(epochs):
        for i in range(x.shape[0]):
            yt = None if y_target is None else y_target[i]
            w, y = solver_volley_step(w, x[i], generator, cfg, mode, yt)
            if trace:
                ys.append(y)
    if not trace:
        return {"w": w}, None
    ys = (
        torch.stack(ys) if ys
        else torch.empty((0, cfg.q), dtype=TIME_DTYPE, device=w.device)
    )
    return {"w": w}, ys.reshape(epochs, x.shape[0], cfg.q)


def _solver_fire(mode: str):
    def fire(params, x, cfg, generator=None):
        t = neuron.fire_times(x, params["w"], cfg.neuron, cfg.t_max, mode)
        return wta.wta(t, cfg.wta, cfg.t_max, generator=generator)

    return fire


# ------------------------------------------------------- fused-kernel side
def _pallas_fire(params, x, cfg: ColumnConfig, generator=None):
    """Kernel-backed batched forward: integer-grid fire + WTA.

    RNL goes through ``ops.rnl_fire`` (the RNL-fire kernel on CUDA
    tensors, its plain version on CPU ones); SNL takes the plain body of
    the same algebra; LIF raises.
    """
    from repro_torch.kernels import ops

    allowed = fused_column.fire_responses("reference")
    if cfg.neuron.response not in allowed:
        raise ValueError(
            f"pallas forward supports response {allowed}, got "
            f"{cfg.neuron.response!r}; use mode='cycle'"
        )
    w = torch.round(torch.clamp(params["w"], 0.0, float(cfg.neuron.w_max)))
    xb = x.reshape((-1, cfg.p))
    if cfg.neuron.response == "snl":
        t = fused_column.fire_dense_ref(
            w, xb, cfg.neuron.threshold, cfg.t_max, response="snl"
        )
    else:
        t = ops.rnl_fire(
            xb, w.contiguous(), cfg.neuron.threshold, cfg.t_max,
            cfg.neuron.w_max,
        )
    t = t.reshape(x.shape[:-1] + (cfg.q,))
    return wta.wta(t, cfg.wta, cfg.t_max, generator=generator)


def _pallas_fit(params, x, cfg, mode, epochs, generator, trace, y_target=None):
    if y_target is not None:
        # supervised targets need the generic loop: a semantic switch
        # (float-weight fire), so only legal when the caller asked 'auto'
        if mode == "pallas":
            raise ValueError(
                "the fused pallas backend has no supervised (y_target) "
                "path; use mode='auto', 'event' or 'cycle'"
            )
        fallback = "cycle" if cfg.neuron.response == "lif" else "event"
        return _solver_fit(
            params, x, cfg, fallback, epochs, generator, trace, y_target
        )
    return fused_column.fit_fused(
        params, x, cfg, epochs,
        lowering=padded_lowering(cfg.neuron.response, params["w"]),
        trace=trace,
    )


# ---------------------------------------------------------------- registry
@dataclasses.dataclass(frozen=True)
class Backend:
    """One simulation backend: batched forward + online-STDP training.

    fire(params, x, cfg, generator) -> (post-WTA times [..., q], winners).
    fit(params, x, cfg, mode, epochs, generator, trace, y_target)
        -> (params, ys or None); ys is [epochs, N, q] online winner times.
    """

    name: str
    fire: Callable
    fit: Callable


_REGISTRY: dict[str, Backend] = {}


def register(backend: Backend) -> None:
    _REGISTRY[backend.name] = backend


def get(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend: {name!r} (have {sorted(_REGISTRY)})"
        ) from None


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _solver_backend(name: str) -> Backend:
    def fit(params, x, cfg, mode, epochs, generator, trace, y_target=None):
        return _solver_fit(params, x, cfg, name, epochs, generator, trace, y_target)

    return Backend(name, _solver_fire(name), fit)


register(_solver_backend("event"))
register(_solver_backend("cycle"))
register(Backend("pallas", _pallas_fire, _pallas_fit))


def _fused_ok(cfg: ColumnConfig) -> bool:
    # Evaluated against the strictest lowering ('cuda', RNL only), as the
    # JAX package does against 'mosaic': 'auto' keeps SNL on the
    # float-weight event solver.
    try:
        fused_column.check_fusable(cfg, "cuda")
        return True
    except ValueError:
        return False


def resolve(mode: str, cfg: ColumnConfig, training: bool = False) -> str:
    """Map the public mode knob to a registry name.

    Forward 'auto' keeps the paper's hybrid: event where exact, cycle for
    LIF.  Training 'auto' prefers the fused path whenever the config fits
    its contract, falling back to the hybrid solvers otherwise.
    """
    if mode != "auto":
        get(mode)  # validate
        return mode
    if cfg.neuron.response == "lif":
        return "cycle"
    if training and _fused_ok(cfg):
        return "pallas"
    return "event"
