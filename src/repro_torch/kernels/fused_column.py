"""Fused TNN column training step: RNL fire + k-WTA + expected STDP.

The hot path of the paper's application-exploration loop: online STDP
folds one volley at a time into the weights, so training is a loop over
epochs x volleys whose body is ONE fused column step.  The step has two
lowerings behind the same semantics:

* ``fused_fit_padded`` — the wrapper of the CUDA kernel
  ``csrc/fused_step.cu`` (port of the JAX package's ``_fused_kernel`` and
  of the scan ``_fused_fit_scan`` around it): ONE launch folds a whole
  fit, epochs x volleys, for a batch of D designs, per-design scalars
  (threshold, effective ``t_max``, live-neuron count, STDP mus) read from
  a runtime ``[D, 6]`` operand array (``design_operands``);
  ``fused_step_padded`` is its one-volley call.  On CPU tensors they take
  their plain versions, ``fused_fit_padded_plain`` (a loop of
  ``fused_step_padded_plain``) and ``fused_step_padded_plain``.
* ``fused_step_ref`` — the plain PyTorch lowering of one design's step
  (dense sub-threshold count over the time window), the counterpart of the
  JAX package's reference lowering.  Exact for RNL/SNL: V(t) is
  nondecreasing, so the count of sub-threshold cycles *is* the first
  crossing.

The padded half serves the design sweep and network layers: D designs in
one (p, q, t_window) envelope, their scalars runtime operands.

* ``fit_scan_padded`` advances epochs x volleys in blocks of ``v_blk``:
  ``fused_block_padded`` wraps ``csrc/fused_block.cu`` (port of
  ``_fused_block_kernel``), one launch folding a whole block in order
  with the weights on chip; ``fused_block_padded_plain`` is its plain
  version and the reference lowering.  Blocking never changes a result.
* ``assign_padded`` fires the whole stream at once: ``fire_block_padded``
  wraps ``csrc/fire_block.cu`` (port of ``_fire_block_kernel``) on the
  integer grid; the reference lowering fires the float weights, on the
  card with ``fire_float_padded`` (``csrc/fire_float.cu``, one launch).

Scope (``check_fusable``): ``response in ('rnl', 'snl')`` (``'rnl'`` only
for the CUDA lowering), expected-mode STDP, index tie-break WTA.

Lowering names: the JAX package's ``'mosaic'`` becomes ``'cuda'`` here;
its validation-only ``'interpret'`` has no counterpart (a CUDA kernel has
no interpreter: the plain version is the oracle).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.types import ColumnConfig, TIME_DTYPE
from repro_torch.kernels import build, ref

LOWERINGS = ("cuda", "reference")

# Columns of the runtime design-operand array (see ``design_operands``).
OPERAND_COLS = (
    "threshold", "t_max", "q_active", "mu_capture", "mu_backoff", "mu_search"
)
N_OPERANDS = len(OPERAND_COLS)


def _pad_volleys_silent(x: torch.Tensor, p_pad: int, sentinel: float) -> torch.Tensor:
    """Widen volleys [..., p] -> [..., p_pad] f32, padding with ``sentinel``
    (any time >= every design's t_max is silent)."""
    xs = torch.full(x.shape[:-1] + (p_pad,), float(sentinel),
                    dtype=torch.float32, device=x.device)
    xs[..., : x.shape[-1]] = x.to(torch.float32)
    return xs


def fire_responses(lowering: str) -> tuple[str, ...]:
    """Response functions the fused fire supports under a given lowering
    (the CUDA kernel implements RNL only)."""
    return ("rnl", "snl") if lowering == "reference" else ("rnl",)


def check_fusable(cfg: ColumnConfig, lowering: str) -> None:
    """Raise ValueError if cfg falls outside the fused step's contract."""
    if lowering not in LOWERINGS:
        raise ValueError(f"unknown lowering: {lowering!r}")
    ok_resp = fire_responses(lowering)
    if cfg.neuron.response not in ok_resp:
        raise ValueError(
            f"fused step ({lowering}) supports response {ok_resp}, got "
            f"{cfg.neuron.response!r}"
        )
    if cfg.stdp.mode != "expected":
        raise ValueError("fused step supports expected-mode STDP only")
    if cfg.wta.tie_break != "index":
        raise ValueError("fused step supports index tie-break WTA only")


# --------------------------------------------------------------- reference
def fire_dense_ref(
    w: torch.Tensor,
    t_in: torch.Tensor,
    threshold,
    t_window: int,
    t_max=None,
    response: str = "rnl",
    acc_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Firing times by dense sub-threshold cycle count.

    w: [..., p, q]; t_in: [..., p] -> [..., q] int32.  ``threshold`` and
    ``t_max`` are numbers or tensors shaped ``[..., 1]``.  ``t_window`` is
    the evaluation length; spike times >= t_max are silent and crossings at
    or past t_max report t_max.  The potential is summed in ``acc_dtype``.
    """
    if t_max is None:
        t_max = t_window
    tv = torch.arange(t_window, dtype=torch.float32, device=t_in.device)
    ti = t_in.to(torch.float32)
    live = (ti < t_max)[..., None]  # [..., p, 1]
    if response == "rnl":
        a = torch.relu(tv - ti[..., None])  # [..., p, T]
        a = torch.where(live, a, 0.0)
        contrib = torch.minimum(a[..., :, None, :], w[..., :, :, None])
    else:  # snl
        s = (tv >= ti[..., None]) & live
        contrib = s[..., :, None, :].to(w.dtype) * w[..., :, :, None]
    v = contrib.sum(dim=-3, dtype=acc_dtype)  # [..., q, T]
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=t_in.device)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=t_in.device)
    if tm.dim():
        tm = tm[..., None]
    if thr.dim():
        thr = thr[..., None]
    below = (v < thr) & (tv < tm)
    count = below.sum(dim=-1).to(torch.float32)
    return torch.minimum(count, tm[..., 0] if tm.dim() else tm).to(TIME_DTYPE)


def fused_step_ref(
    w: torch.Tensor,
    t_in: torch.Tensor,
    threshold,
    t_window: int,
    w_max: int,
    wta_k: int,
    mu_capture: float,
    mu_backoff: float,
    mu_search: float,
    stabilize: bool,
    t_max=None,
    response: str = "rnl",
    integer_fire: bool = False,
    q_active=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused column step, plain lowering.  [p, q], [p] -> (w_new, y).

    ``q_active`` masks neurons >= q_active out of WTA and STDP (None: all
    live).  ``integer_fire`` rounds weights to the hardware grid for the
    fire (the CUDA lowering always does).
    """
    if t_max is None:
        t_max = t_window
    w_fire = torch.round(torch.clamp(w, 0.0, float(w_max))) if integer_fire else w
    t_fire = fire_dense_ref(w_fire, t_in, threshold, t_window, t_max, response)
    qi = torch.arange(w.shape[1], dtype=TIME_DTYPE, device=w.device)
    if q_active is not None:
        t_fire = torch.where(qi < q_active, t_fire, t_max)
    y = ref.wta_ref(t_fire[None], wta_k, t_max)[0]
    w_new = ref.stdp_ref(
        w, t_in, y, mu_capture, mu_backoff, mu_search, w_max, t_max,
        stabilize=stabilize, compiled=True,
    )
    if q_active is not None:
        w_new = torch.where(qi[None, :] < q_active, w_new, w)
    return w_new, y


def _wta_min_rounds(t_fire: torch.Tensor, t_max: torch.Tensor, wta_k: int) -> torch.Tensor:
    """k-WTA priority encoder by min rounds over the unique key t * q + j
    (the JAX package's ``_kernel_wta``; equal to ``ref.wta_ref``).
    t_fire: [D, q] f32; t_max: [D, 1] -> [D, q] winner times."""
    q = t_fire.shape[-1]
    qi = torch.arange(q, dtype=torch.float32, device=t_fire.device)
    key = t_fire * q + qi
    big = torch.finfo(torch.float32).max
    rem = key
    kth = torch.zeros_like(key[..., :1])
    for _ in range(wta_k):
        kth = rem.amin(dim=-1, keepdim=True)
        rem = torch.where(rem <= kth, big, rem)
    win = (key <= kth) & (t_fire < t_max)
    return torch.where(win, t_fire, t_max)


# ------------------------------------------------------------ the kernel
def design_operands(
    thresholds,
    t_maxes,
    q_actives,
    mu_capture,
    mu_backoff,
    mu_search,
    device=None,
) -> torch.Tensor:
    """Pack per-design runtime scalars into the kernel's operand array.

    Returns [D, N_OPERANDS] f32, one row per design, columns ordered as
    ``OPERAND_COLS``.  The mus may be numbers (broadcast across designs)
    or [D] sequences.
    """
    d = len(thresholds)
    cols = (thresholds, t_maxes, q_actives, mu_capture, mu_backoff, mu_search)
    arr = np.stack(
        [np.broadcast_to(np.asarray(c, np.float32), (d,)) for c in cols], axis=1
    )
    return torch.as_tensor(arr, device=device)


def _eps(w_max: int) -> float:
    """The stabilizer's 1 / (2 w_max), rounded to f32 as the plain
    versions round the same Python constant."""
    return float(np.float32(1.0 / (2 * w_max)))


def _check_cuda_operands(name: str, tensors: tuple, times: tuple = ()) -> None:
    """The wrappers' common checks: f32 ``tensors`` and int32 or f32
    ``times``, contiguous, on one CUDA device."""
    every = tuple(tensors) + tuple(times)
    if any(t.dtype != torch.float32 for t in tensors) or any(
        t.dtype not in (TIME_DTYPE, torch.float32) for t in times
    ):
        raise ValueError(
            f"{name} needs float32 tensors and int32 or float32 times, got "
            f"{[t.dtype for t in every]}"
        )
    if any(not t.is_contiguous() for t in every):
        raise ValueError(f"{name} needs contiguous tensors")
    dev = every[0].device
    if not all(t.is_cuda and t.device == dev for t in every):
        raise ValueError(
            f"{name} needs its tensors on one CUDA device (or all on the "
            f"CPU), got {[str(t.device) for t in every]}"
        )


def fused_step_padded_plain(
    w: torch.Tensor,
    t_in: torch.Tensor,
    operands: torch.Tensor,
    *,
    t_window: int,
    w_max: int,
    wta_k: int,
    stabilize: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the CUDA fused step (same arguments)."""
    thr, tm, qa, mc, mb, ms = (operands[:, k : k + 1] for k in range(N_OPERANDS))
    q = w.shape[2]
    wi = torch.round(torch.clamp(w, 0.0, float(w_max)))
    t_fire = fire_dense_ref(wi, t_in, thr, t_window, tm).to(torch.float32)
    qi = torch.arange(q, dtype=torch.float32, device=w.device)
    t_fire = torch.where(qi < qa, t_fire, tm)
    y = _wta_min_rounds(t_fire, tm, wta_k)
    w_new = ref.stdp_ref(
        w, t_in, y, mc[..., None], mb[..., None], ms[..., None], w_max,
        tm[..., None], stabilize=stabilize, compiled=True,
    )
    w_new = torch.where((qi < qa)[:, None, :], w_new, w)
    return w_new, y


def fused_step_padded(
    w: torch.Tensor,
    t_in: torch.Tensor,
    operands: torch.Tensor,
    *,
    t_window: int,
    w_max: int,
    wta_k: int,
    stabilize: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused step for D designs: the one-volley call of the kernel
    ``csrc/fused_step.cu`` (``fused_fit_padded`` with N = 1, one epoch).

    Args:
      w: [D, p, q] f32 weights (pad rows/columns zero).
      t_in: [D, p] f32 or int32 volley per design; a time >= that design's
        runtime ``t_max`` is silent.
      operands: [D, N_OPERANDS] f32 runtime design operands
        (``design_operands``); every ``t_max`` <= ``t_window``.
      t_window: evaluation length of the envelope.

    Returns:
      (w_new [D, p, q], y [D, q] f32 post-WTA winner times).

    CPU tensors take ``fused_step_padded_plain``; CUDA tensors launch the
    kernel (or raise).
    """
    kw = dict(t_window=t_window, w_max=w_max, wta_k=wta_k, stabilize=stabilize)
    tensors = (w, t_in, operands)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_step_padded_plain(w, t_in, operands, **kw)
    if t_in.dim() != 2:
        raise ValueError(f"t_in must be [D, p], got {tuple(t_in.shape)}")
    w_out, y, _ = _launch_fused_fit(
        "fused_step_padded", w, t_in[:, None], operands, epochs=1,
        trace=False, last=True, **kw)
    return w_out, y


def fused_fit_padded_plain(
    w: torch.Tensor,
    xs: torch.Tensor,
    operands: torch.Tensor,
    *,
    epochs: int,
    t_window: int,
    w_max: int,
    wta_k: int,
    stabilize: bool,
    trace: bool = False,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the folded kernel (same arguments):
    ``fused_step_padded_plain`` over epochs x volleys, in order."""
    d, n, _ = xs.shape
    xf = xs.to(torch.float32)  # exact: every time is below 2^24
    ys = (torch.empty((d, epochs, n, w.shape[2]), dtype=TIME_DTYPE,
                      device=w.device) if trace else None)
    for e in range(epochs):
        for i in range(n):
            w, y = fused_step_padded_plain(
                w, xf[:, i], operands, t_window=t_window, w_max=w_max,
                wta_k=wta_k, stabilize=stabilize,
            )
            if trace:
                ys[:, e, i] = y.to(TIME_DTYPE)
    return w, ys


def fused_fit_padded(
    w: torch.Tensor,
    xs: torch.Tensor,
    operands: torch.Tensor,
    *,
    epochs: int,
    t_window: int,
    w_max: int,
    wta_k: int,
    stabilize: bool,
    trace: bool = False,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A whole online-STDP fit for D designs in ONE launch of
    ``csrc/fused_step.cu``: epochs x N volleys folded in order (the
    counterpart of the JAX package's ``_fused_fit_scan`` over
    ``_fused_kernel``).

    Args:
      w: [D, p, q] f32 weights (pad rows/columns zero).
      xs: [D, N, p] int32 or f32 volleys; a time >= that design's runtime
        ``t_max`` is silent.
      operands: [D, N_OPERANDS] f32 runtime design operands.
      trace: also return every volley's post-WTA winner times.

    Returns:
      (w_new [D, p, q], ys [D, epochs, N, q] ``TIME_DTYPE`` when ``trace``
      else None).

    CPU tensors take ``fused_fit_padded_plain``; CUDA tensors launch the
    kernel once (or raise), with no host sync.  A design whose volleys are
    int32 with every time >= 0 fires by the kernel's slope histogram; f32
    volleys, and int32 volleys with a negative time, by its ramp sum: each
    thread block decides for its own design.  The kernel writes the trace itself, and keeps the
    weights in shared memory for the whole fit where they fit beside two
    volleys and the histogram (``build.FUSED_STEP.resident``), else in
    device memory.
    """
    kw = dict(epochs=epochs, t_window=t_window, w_max=w_max, wta_k=wta_k,
              stabilize=stabilize, trace=trace)
    tensors = (w, xs, operands)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_fit_padded_plain(w, xs, operands, **kw)
    if xs.dim() != 3:
        raise ValueError(f"xs must be [D, N, p], got {tuple(xs.shape)}")
    w_out, _, ys = _launch_fused_fit("fused_fit_padded", w, xs, operands,
                                     last=False, **kw)
    return w_out, ys


def _launch_fused_fit(
    name: str,
    w: torch.Tensor,
    xs: torch.Tensor,
    operands: torch.Tensor,
    *,
    epochs: int,
    t_window: int,
    w_max: int,
    wta_k: int,
    stabilize: bool,
    trace: bool,
    last: bool,
) -> tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Checks the operands and launches the folded kernel once: (w_new,
    the last volley's winner times [D, q] f32 when ``last``, the trace
    [D, epochs, N, q] when ``trace``)."""
    _check_cuda_operands(name, (w, operands), (xs,))
    if w.dim() != 3:
        raise ValueError(f"w must be [D, p, q], got {tuple(w.shape)}")
    d, p, q = w.shape
    n = xs.shape[1]
    if (xs.shape[0], xs.shape[2]) != (d, p) or tuple(operands.shape) != (
        d, N_OPERANDS
    ):
        raise ValueError(
            f"{name}: w {tuple(w.shape)} needs volleys {(d, n, p)} and "
            f"operands {(d, N_OPERANDS)}, got {tuple(xs.shape)} and "
            f"{tuple(operands.shape)}"
        )
    if wta_k < 1:
        raise ValueError(f"wta_k must be >= 1, got {wta_k}")
    if epochs < 0:
        raise ValueError(f"epochs must be >= 0, got {epochs}")
    k = build.FUSED_STEP
    resident = k.resident(f"a {p} x {q} envelope", p, q, int(t_window))
    int_times = xs.dtype == TIME_DTYPE
    w_out = torch.empty_like(w)
    y = torch.empty((d, q), dtype=torch.float32, device=w.device) if last else None
    ys = (torch.empty((d, epochs, n, q), dtype=TIME_DTYPE, device=w.device)
          if trace else None)
    if d == 0:
        return w_out, y, ys
    fn = k.function()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        k.launches += 1
        rc = fn(w.data_ptr(), xs.data_ptr(), operands.data_ptr(),
                w_out.data_ptr(), build.ptr(y), build.ptr(ys), int(resident),
                int(int_times), d, n, int(epochs), p, q,
                int(t_window), int(w_max), int(wta_k), int(bool(stabilize)),
                _eps(w_max), stream)
    build.check_launch(k, rc)
    return w_out, y, ys


# ------------------------------------------------------------- fused fit
def fit_fused(
    params: dict,
    x: torch.Tensor,
    cfg: ColumnConfig,
    epochs: int = 8,
    lowering: str = "reference",
    trace: bool = False,
) -> tuple[dict, Optional[torch.Tensor]]:
    """Online STDP over [N, p] volleys: epochs x volleys fused steps.

    ``lowering='reference'`` folds ``fused_step_ref`` (integer-grid fire,
    as the kernel); ``'cuda'`` calls ``fused_fit_padded`` once (D = 1),
    which launches the kernel once for the whole fit on CUDA tensors.
    Volleys may be integer or float.  Returns (params, ys) where ys is
    [epochs, N, q] int32 winner times when ``trace`` else None.
    ``params`` is not modified.
    """
    check_fusable(cfg, lowering)
    w = params["w"].to(torch.float32).clone()
    n = x.shape[0]
    if lowering == "reference":
        ys = []
        for _ in range(epochs):
            for xt in x:
                w, y = fused_step_ref(
                    w, xt, cfg.neuron.threshold, cfg.t_max, cfg.neuron.w_max,
                    cfg.wta.k, cfg.stdp.mu_capture, cfg.stdp.mu_backoff,
                    cfg.stdp.mu_search, cfg.stdp.stabilizer == "half",
                    response=cfg.neuron.response, integer_fire=True,
                )
                if trace:
                    ys.append(y)
        if not trace:
            return {"w": w}, None
        if not ys:
            return {"w": w}, torch.empty((epochs, n, cfg.q), dtype=TIME_DTYPE,
                                         device=w.device)
        return {"w": w}, torch.stack(ys).to(TIME_DTYPE).reshape(epochs, n, cfg.q)
    operands = design_operands(
        [cfg.neuron.threshold], [cfg.t_max], [cfg.q], cfg.stdp.mu_capture,
        cfg.stdp.mu_backoff, cfg.stdp.mu_search, device=w.device,
    )
    # int32 and f32 volleys go to the kernel as they are; any other dtype
    # as f32, the plain versions' working type
    xs = x if x.dtype in (TIME_DTYPE, torch.float32) else x.to(torch.float32)
    w_new, ys = fused_fit_padded(
        w[None], xs[None].contiguous(), operands, epochs=epochs,
        t_window=cfg.t_max, w_max=cfg.neuron.w_max, wta_k=cfg.wta.k,
        stabilize=cfg.stdp.stabilizer == "half", trace=trace,
    )
    return {"w": w_new[0]}, (ys[0] if trace else None)


# ------------------------------------------------------- the padded half
# The envelope contract: D designs padded into one (p, q, t_window)
# envelope; a design's threshold, t_max, live-neuron count and STDP mus
# are runtime operands (``design_operands``); pad synapses and pad
# volleys are silent (time >= every design's t_max), pad neurons sit at
# or past ``q_active``.
def pad_stream_silent(xs: torch.Tensor, n_total: int, sentinel) -> torch.Tensor:
    """Pad a volley stream [n, ...] to [n_total, ...] with silent rows
    (every time ``sentinel``, which must be >= every design's t_max).

    Silent rows assign to the 'unclustered' id and, for positive
    thresholds, are an exact weight no-op under the fused STDP step.
    """
    n = xs.shape[0]
    if n > n_total:
        raise ValueError(f"stream of {n} volleys exceeds batch of {n_total}")
    pad = torch.full((n_total - n,) + tuple(xs.shape[1:]), sentinel,
                     dtype=xs.dtype, device=xs.device)
    return torch.cat([xs, pad], dim=0)


def _pad_volley_blocks(
    xs: torch.Tensor, v_blk: int, sentinel
) -> tuple[torch.Tensor, list[int]]:
    """[N, ...] volleys -> ([S, v_blk, ...] blocks, S valid counts).

    The tail of the last block is silent-padded, and its valid count
    keeps the tail out of the weight fold for any design (a silent volley
    still fires every neuron of a design with threshold <= 0).
    """
    n = xs.shape[0]
    s = -(-n // v_blk)
    n_valid = [min(v_blk, n - v_blk * i) for i in range(s)]
    xs = pad_stream_silent(xs, s * v_blk, sentinel)
    return xs.reshape((s, v_blk) + tuple(xs.shape[1:])), n_valid


def fused_block_padded_plain(
    w: torch.Tensor,
    t_in: torch.Tensor,
    operands: torch.Tensor,
    n_valid: int,
    *,
    t_window: int,
    w_max: int,
    wta_k: int,
    stabilize: bool,
    response: str = "rnl",
) -> torch.Tensor:
    """Plain PyTorch version of the CUDA volley block (same arguments):
    the first ``n_valid`` volleys of ``t_in`` [D, v_blk, p] folded in
    order, each one fused step on the integer grid.  ``response='snl'``
    is the reference lowering's step fire, which no kernel has."""
    thr, tm, qa, mc, mb, ms = (operands[:, k : k + 1] for k in range(N_OPERANDS))
    q = w.shape[2]
    qi = torch.arange(q, dtype=torch.float32, device=w.device)
    live = (qi < qa)[:, None, :]
    for vi in range(min(n_valid, t_in.shape[1])):
        x = t_in[:, vi]
        wi = torch.round(torch.clamp(w, 0.0, float(w_max)))
        t_fire = fire_dense_ref(wi, x, thr, t_window, tm, response)
        t_fire = torch.where(qi < qa, t_fire.to(torch.float32), tm)
        y = _wta_min_rounds(t_fire, tm, wta_k)
        w_new = ref.stdp_ref(
            w, x, y, mc[..., None], mb[..., None], ms[..., None], w_max,
            tm[..., None], stabilize=stabilize, compiled=True,
        )
        w = torch.where(live, w_new, w)
    return w


def fused_block_padded(
    w: torch.Tensor,
    t_in: torch.Tensor,
    operands: torch.Tensor,
    n_valid: int,
    *,
    t_window: int,
    w_max: int,
    wta_k: int,
    stabilize: bool,
) -> torch.Tensor:
    """One volley block for D designs: the wrapper of ``csrc/fused_block.cu``.

    Args:
      w: [D, p, q] f32 weights (pad rows/columns zero).
      t_in: [D, v_blk, p] f32 volley block per design, integer times >= 0
        (the kernel's slope-histogram fire is exact for those only); a
        time >= that design's runtime ``t_max`` is silent.
      operands: [D, N_OPERANDS] f32 runtime design operands.
      n_valid: volleys of the block to fold; the rest fold nothing.

    Returns w_new [D, p, q] after the block's sequential online updates.
    CPU tensors take ``fused_block_padded_plain``; CUDA tensors launch the
    kernel (or raise), once per block, or once per sub-block where the
    block's volleys do not fit in shared memory (``block_sub_launches``).
    An envelope whose weights do not fit in shared memory beside one
    volley and the fire's histogram (pq + p + 2q words + q (t_window + 1)
    ints over 227 KB, ~57 K synapses at t_window 64) runs in the kernel's
    device-memory layout.
    """
    kw = dict(t_window=t_window, w_max=w_max, wta_k=wta_k, stabilize=stabilize)
    tensors = (w, t_in, operands)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_block_padded_plain(w, t_in, operands, n_valid, **kw)
    _check_cuda_operands("fused_block_padded", tensors)
    if w.dim() != 3 or t_in.dim() != 3:
        raise ValueError(
            f"fused_block_padded needs w [D, p, q] and t_in [D, v_blk, p], "
            f"got {tuple(w.shape)} and {tuple(t_in.shape)}"
        )
    d, p, q = w.shape
    v_blk = t_in.shape[1]
    if (t_in.shape[0], t_in.shape[2]) != (d, p) or tuple(operands.shape) != (
        d, N_OPERANDS
    ):
        raise ValueError(
            f"fused_block_padded: w {tuple(w.shape)} needs t_in "
            f"{(d, v_blk, p)} and operands {(d, N_OPERANDS)}, got "
            f"{tuple(t_in.shape)} and {tuple(operands.shape)}"
        )
    if wta_k < 1:
        raise ValueError(f"wta_k must be >= 1, got {wta_k}")
    k = build.FUSED_BLOCK
    resident = k.resident(f"one volley of a {p} x {q} envelope", p, q, 1,
                          int(t_window))
    if d == 0:
        return torch.empty_like(w)
    fn = k.function()
    for start, v, nv in block_sub_launches(p, q, v_blk, n_valid, t_window):
        sub = t_in if v == v_blk else t_in[:, start : start + v].contiguous()
        w_out = torch.empty_like(w)
        with torch.cuda.device(w.device):
            stream = torch.cuda.current_stream(w.device).cuda_stream
            k.launches += 1
            rc = fn(w.data_ptr(), sub.data_ptr(), operands.data_ptr(),
                    w_out.data_ptr(), int(resident), d, p, q, v, nv,
                    int(t_window), int(w_max), int(wta_k),
                    int(bool(stabilize)), _eps(w_max), stream)
        build.check_launch(k, rc)
        w = w_out
    return w


def block_sub_launches(
    p: int, q: int, v_blk: int, n_valid: int, t_window: int
) -> list[tuple[int, int, int]]:
    """How ``fused_block_padded`` launches one block of ``v_blk`` volleys
    in a p x q envelope of ``t_window`` cycles: (first volley, volleys
    staged, volleys folded) per launch.

    One launch takes the whole block when its volleys fit in a thread
    block's shared memory in the layout the wrapper picks (beside the
    weights where one volley fits so, else beside the firing times and
    the fire's histogram alone).
    Otherwise the block's first ``n_valid`` volleys fold as consecutive
    launches of the largest sub-block that fits (the kernel's own
    ``_smem_bytes`` decides), in order; volleys fold in order either way,
    so the result is the same function of the inputs.
    """
    k = build.FUSED_BLOCK
    t_window = int(t_window)
    resident = k.resident(f"one volley of a {p} x {q} envelope", p, q, 1,
                          t_window)
    v_fit = v_blk
    while v_fit > 1 and k.smem_bytes(
        p, q, v_fit, t_window, resident=resident
    ) > build.MAX_SMEM_BYTES:
        v_fit -= 1
    if v_fit >= v_blk:
        return [(0, v_blk, int(n_valid))]
    n_fold = max(0, min(int(n_valid), v_blk))
    return [(s, min(v_fit, n_fold - s), min(v_fit, n_fold - s))
            for s in range(0, n_fold, v_fit)]


def fit_scan_padded(
    w: torch.Tensor,
    xs: torch.Tensor,
    thresholds,
    t_maxes,
    q_actives,
    *,
    t_window: int,
    w_max: int,
    wta_k: int,
    mu_capture,
    mu_backoff,
    mu_search,
    stabilize: bool,
    response: str,
    epochs: int,
    lowering: str = "reference",
    v_blk: int,
) -> torch.Tensor:
    """All designs x epochs x volleys of a padded envelope, online.

    ``w`` [D, p, q] f32 and ``xs`` [N, D, p] integer volleys (scan axis
    leading, pad synapses at >= t_window), one threshold / t_max /
    q_active per design.  The scan advances in blocks of ``v_blk``
    volleys: ``'cuda'`` launches ``fused_block_padded`` once per block,
    ``'reference'`` folds the same block with its plain version (RNL or
    SNL).  The ``'cuda'`` lowering raises on floating-point ``xs``: its
    kernel's fire is exact for integer spike times only (the callers pass
    ``TIME_DTYPE``).  Results are the same for every ``v_blk``: blocking
    changes the schedule, never the online rule; callers take it from
    their ``backend.execution_plan``.  ``w`` is not modified.
    """
    if lowering not in LOWERINGS:
        raise ValueError(f"unknown lowering: {lowering!r}")
    if xs.shape[0] == 0:
        raise ValueError(
            "fit_scan_padded needs at least one volley (got an empty "
            "stream, N=0)"
        )
    if epochs == 0:
        return w
    if response not in fire_responses(lowering):
        raise ValueError(
            f"the padded {lowering} lowering supports response "
            f"{fire_responses(lowering)}, got {response!r}; use "
            "lowering='reference'"
        )
    if lowering == "cuda" and xs.is_floating_point():
        raise ValueError(
            f"the padded cuda lowering needs integer volleys (the kernel's "
            f"fire is exact for integer spike times), got {xs.dtype}; pass "
            f"{TIME_DTYPE}"
        )
    dev = w.device
    operands = design_operands(
        _floats(thresholds), _floats(t_maxes), _floats(q_actives),
        mu_capture, mu_backoff, mu_search, device=dev,
    )
    # volleys in blocks, design axis leading: [S, D, v_blk, p] f32
    xsb, n_valid = _pad_volley_blocks(
        xs.to(device=dev, dtype=torch.float32), v_blk, float(t_window)
    )
    xsb = xsb.permute(0, 2, 1, 3).contiguous()
    kw = dict(t_window=t_window, w_max=w_max, wta_k=wta_k, stabilize=stabilize)
    w = w.to(torch.float32).contiguous()
    for _ in range(epochs):
        for blk, nv in zip(xsb, n_valid):
            if lowering == "cuda":
                w = fused_block_padded(w, blk, operands, nv, **kw)
            else:
                w = fused_block_padded_plain(
                    w, blk, operands, nv, response=response, **kw
                )
    return w


def _floats(v) -> np.ndarray:
    """A per-design sequence (list, array or tensor) as host floats."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


# ----------------------------------------------------- batched assignment
def fire_chunk(d: int, p: int, q: int, t_window: int) -> int:
    """Volleys a chunk of ``_fire_designs``: bounds the [D, chunk, p, q, T]
    transient."""
    return max(1, (1 << 25) // max(1, d * p * q * t_window))


def _fire_designs(
    w: torch.Tensor,
    xs: torch.Tensor,
    thr: torch.Tensor,
    tm: torch.Tensor,
    qa: torch.Tensor,
    t_window: int,
    response: str,
) -> torch.Tensor:
    """Firing times of every volley of every design, dense and chunked:
    the plain version of ``csrc/fire_float.cu`` (``fire_float_padded``),
    and the float-weight fire of CPU tensors and of SNL.

    w [D, p, q]; xs [D, N, p]; thr, tm, qa [D, 1, 1] -> [D, N, q] f32,
    clamped to t_max, neurons at or past q_active at t_max.  The
    potential is summed in float64: on integer-grid weights that is the
    f32 sum exactly, and on float weights it makes the result independent
    of the order in which the device reduces (so card, kernel and CPU
    agree).
    The JAX package's reference sums float weights in float32, so a
    potential within float32 rounding of the threshold could cross one
    cycle apart; none did at WordSynonyms width
    (``tests/test_torch_sweep.py``).
    """
    d, n, p = xs.shape
    q = w.shape[2]
    chunk = fire_chunk(d, p, q, t_window)
    qi = torch.arange(q, dtype=torch.float32, device=w.device)
    out = []
    for c in range(0, n, chunk):
        t = fire_dense_ref(
            w[:, None], xs[:, c : c + chunk], thr, t_window, tm, response,
            acc_dtype=torch.float64,
        ).to(torch.float32)
        out.append(torch.where(qi < qa, t, tm))
    return torch.cat(out, dim=1)


def fire_block_padded_plain(
    w: torch.Tensor,
    xs: torch.Tensor,
    operands: torch.Tensor,
    *,
    t_window: int,
    w_max: int,
) -> torch.Tensor:
    """Plain PyTorch version of the CUDA batched fire (same arguments;
    int32 and float32 volleys of the same times give the same result):
    the float-weight fire of the weights rounded to the grid."""
    wi = torch.round(torch.clamp(w, 0.0, float(w_max)))
    return fire_float_padded_plain(wi, xs, operands, t_window=t_window)


def fire_block_padded(
    w: torch.Tensor,
    xs: torch.Tensor,
    operands: torch.Tensor,
    *,
    t_window: int,
    w_max: int,
) -> torch.Tensor:
    """Frozen-weight fire of N volleys for D designs on the integer grid:
    the wrapper of ``csrc/fire_block.cu``.

    Args:
      w: [D, p, q] f32 weights (rounded to the grid inside).
      xs: [D, N, p] int32 or f32 volleys; a time >= the design's t_max is
        silent.  The kernel reads int32 times as they are and fires a tile
        of them by its slope histogram where none is negative (else, and
        for f32 times, by the ramp sum; the result is the same).
      operands: [D, N_OPERANDS] f32 (threshold, t_max, q_active used).

    Returns t_fire [D, N, q] f32, clamped to t_max, neurons at or past
    q_active at t_max.  CPU tensors take ``fire_block_padded_plain``;
    CUDA tensors launch the kernel (or raise), in its device-memory layout
    where the grid does not fit in shared memory beside a tile of volleys
    and the warps' rows.
    """
    if all(t.device.type == "cpu" for t in (w, xs, operands)):
        return fire_block_padded_plain(w, xs, operands, t_window=t_window,
                                       w_max=w_max)
    k = build.FIRE_BLOCK
    resident, t_fire = _fire_launch_operands(k, w, xs, operands, t_window)
    d, n, p = xs.shape
    q = w.shape[2]
    if d == 0 or n == 0:
        return t_fire
    grid = build.grid_workspace(w, resident)
    fn = k.function()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        k.launches += 1
        rc = fn(operands.data_ptr(), xs.data_ptr(), w.data_ptr(), build.ptr(grid),
                int(resident), int(xs.dtype == TIME_DTYPE), t_fire.data_ptr(),
                d, n, p, q, int(t_window), int(w_max), stream)
    build.check_launch(k, rc)
    return t_fire


def _fire_launch_operands(
    k: build.CudaKernel, w: torch.Tensor, xs: torch.Tensor,
    operands: torch.Tensor, t_window: int,
) -> tuple[bool, torch.Tensor]:
    """The frozen-weight fire wrappers' checks (shapes, then dtypes,
    contiguity and one CUDA device), all before any build or launch; then
    the layout the kernel takes and the [D, N, q] f32 output."""
    name = f"{k.name}_padded"
    if w.dim() != 3 or xs.dim() != 3:
        raise ValueError(
            f"{name} needs w [D, p, q] and xs [D, N, p], got "
            f"{tuple(w.shape)} and {tuple(xs.shape)}"
        )
    d, p, q = w.shape
    n = xs.shape[1]
    if (xs.shape[0], xs.shape[2]) != (d, p) or tuple(operands.shape) != (
        d, N_OPERANDS
    ):
        raise ValueError(
            f"{name}: w {tuple(w.shape)} needs xs {(d, n, p)} and operands "
            f"{(d, N_OPERANDS)}, got {tuple(xs.shape)} and "
            f"{tuple(operands.shape)}"
        )
    _check_cuda_operands(name, (w, operands), times=(xs,))
    resident = k.resident(f"a {p} x {q} envelope", p, q, int(t_window))
    return resident, torch.empty((d, n, q), dtype=torch.float32, device=w.device)


def fire_float_padded_plain(
    w: torch.Tensor,
    xs: torch.Tensor,
    operands: torch.Tensor,
    *,
    t_window: int,
) -> torch.Tensor:
    """Plain PyTorch version of the CUDA float-weight fire (same
    arguments): ``_fire_designs`` on the weights as they are."""
    ops = operands[:, :, None]
    return _fire_designs(w, xs, ops[:, 0:1], ops[:, 1:2], ops[:, 2:3],
                         t_window, "rnl")


def fire_float_padded(
    w: torch.Tensor,
    xs: torch.Tensor,
    operands: torch.Tensor,
    *,
    t_window: int,
) -> torch.Tensor:
    """Frozen-weight RNL fire of N volleys for D designs on the float
    weights as they are: the wrapper of ``csrc/fire_float.cu``.

    Args:
      w: [D, p, q] f32 weights, unrounded (any values, NaN and +-inf too).
      xs: [D, N, p] int32 or f32 volleys; a time >= the design's t_max is
        silent.  The kernel reads int32 times as they are and fires a tile
        of them in the slope form where none is negative (else, and for
        f32 times, by the float64 ramp sum; the result is the same).
      operands: [D, N_OPERANDS] f32 (threshold, t_max, q_active used).

    Returns t_fire [D, N, q] f32, clamped to t_max, neurons at or past
    q_active at t_max: ``fire_float_padded_plain``'s times bit for bit
    wherever its float64 sum is exact (see the source).  CPU tensors take
    the plain version; CUDA tensors launch the kernel once (or raise),
    with the weights in shared memory where they fit beside a tile of
    volleys and the warps' rows, else read through L2.
    """
    if all(t.device.type == "cpu" for t in (w, xs, operands)):
        return fire_float_padded_plain(w, xs, operands, t_window=t_window)
    k = build.FIRE_FLOAT
    resident, t_fire = _fire_launch_operands(k, w, xs, operands, t_window)
    d, n, p = xs.shape
    q = w.shape[2]
    if d == 0 or n == 0:
        return t_fire
    fn = k.function()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        k.launches += 1
        rc = fn(operands.data_ptr(), xs.data_ptr(), w.data_ptr(),
                int(resident), int(xs.dtype == TIME_DTYPE), t_fire.data_ptr(),
                d, n, p, q, int(t_window), stream)
    build.check_launch(k, rc)
    return t_fire


def _ids_from_times(
    t_fire: torch.Tensor, t_maxes: torch.Tensor, q_actives: torch.Tensor
) -> torch.Tensor:
    """Firing times [D, N, q] -> cluster ids [D, N]: the earliest-firing
    neuron (the first index among ties, as ``torch.argmin`` returns it),
    or the design's q_active when no neuron fires."""
    tm = t_maxes.to(torch.float32)[:, None, None]
    tf = t_fire.to(torch.float32)
    spiked = (tf < tm).any(dim=-1)
    idx = torch.argmin(tf, dim=-1)
    return torch.where(spiked, idx, q_actives.to(idx.dtype)[:, None]).to(
        TIME_DTYPE
    )


def assign_padded(
    w: torch.Tensor,
    xs: torch.Tensor,
    thresholds,
    t_maxes,
    q_actives,
    *,
    t_window: int,
    response: str,
    lowering: str = "reference",
    w_max: Optional[int] = None,
) -> torch.Tensor:
    """Cluster ids for every padded design: [N, D, p] volleys -> [D, N].

    No volley depends on another, so the whole stream is fired at once.
    ``'cuda'`` fires the integer weight grid with ``fire_block_padded``
    (one launch; ``w_max`` required, and only a pure lowering choice when
    the weights are on the grid, see ``backend.assign_lowering``);
    ``'reference'`` fires the float weights as they are: on CUDA tensors
    and RNL with ``fire_float_padded`` (one launch), else (CPU tensors,
    SNL) with ``_fire_designs``, in chunks of volleys sized to bound
    memory (the JAX package's ``v_blk`` blocks; no result depends on
    them).
    The id is the winner index, or q_active for a silent volley; k-WTA
    keeps the global minimum for any k, so no ``wta_k`` is needed.
    """
    if lowering not in LOWERINGS:
        raise ValueError(f"unknown lowering: {lowering!r}")
    if xs.shape[0] == 0:
        raise ValueError(
            "assign_padded needs at least one volley (got an empty "
            "stream, N=0)"
        )
    if response not in fire_responses(lowering):
        raise ValueError(
            f"the padded {lowering} lowering supports response "
            f"{fire_responses(lowering)}, got {response!r}; use "
            "lowering='reference'"
        )
    if lowering == "cuda" and w_max is None:
        raise ValueError(
            "the kernel assign lowering needs w_max (integer-grid fire)"
        )
    dev = w.device
    tm = torch.as_tensor(_floats(t_maxes), dtype=torch.float32, device=dev)
    qa = torch.as_tensor(_floats(q_actives), dtype=torch.float32, device=dev)
    w = w.to(torch.float32).contiguous()
    kernel = lowering == "cuda" or (dev.type == "cuda" and response == "rnl")
    if obs.ON:
        obs.count("assign.chunks", 1 if kernel else -(
            -xs.shape[0] // fire_chunk(*w.shape, t_window)))
    if kernel:
        operands = design_operands(
            _floats(thresholds), _floats(t_maxes), _floats(q_actives),
            0.0, 0.0, 0.0, device=dev,
        )
        # int32 volleys as they are (the kernels' slope form), others as f32
        dt = TIME_DTYPE if xs.dtype == TIME_DTYPE else torch.float32
        xs_d = xs.to(device=dev, dtype=dt).transpose(0, 1).contiguous()
        if lowering == "cuda":
            t_fire = fire_block_padded(w, xs_d, operands, t_window=t_window,
                                       w_max=w_max)
        else:
            t_fire = fire_float_padded(w, xs_d, operands, t_window=t_window)
    else:
        xs_d = xs.to(device=dev, dtype=torch.float32).transpose(0, 1).contiguous()
        thr = torch.as_tensor(_floats(thresholds), dtype=torch.float32,
                              device=dev)
        t_fire = _fire_designs(w, xs_d, thr[:, None, None], tm[:, None, None],
                               qa[:, None, None], t_window, response)
    return _ids_from_times(t_fire, tm, qa)
