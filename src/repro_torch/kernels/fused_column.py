"""Fused TNN column training step: RNL fire + k-WTA + expected STDP.

The hot path of the paper's application-exploration loop: online STDP
folds one volley at a time into the weights, so training is a loop over
epochs x volleys whose body is ONE fused column step.  The step has two
lowerings behind the same semantics:

* ``fused_step_padded`` — the wrapper of the CUDA kernel
  ``csrc/fused_step.cu`` (port of the JAX package's ``_fused_kernel``):
  one launch per volley for a batch of D designs, per-design scalars
  (threshold, effective ``t_max``, live-neuron count, STDP mus) read from
  a runtime ``[D, 6]`` operand array (``design_operands``).  On CPU
  tensors it takes its plain version, ``fused_step_padded_plain``.
* ``fused_step_ref`` — the plain PyTorch lowering of one design's step
  (dense sub-threshold count over the time window), the counterpart of the
  JAX package's reference lowering.  Exact for RNL/SNL: V(t) is
  nondecreasing, so the count of sub-threshold cycles *is* the first
  crossing.

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
) -> torch.Tensor:
    """Firing times by dense sub-threshold cycle count.

    w: [..., p, q]; t_in: [..., p] -> [..., q] int32.  ``threshold`` and
    ``t_max`` are numbers or tensors shaped ``[..., 1]``.  ``t_window`` is
    the evaluation length; spike times >= t_max are silent and crossings at
    or past t_max report t_max.
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
    v = contrib.sum(dim=-3)  # [..., q, T]
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
        stabilize=stabilize,
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
        tm[..., None], stabilize=stabilize,
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
    """One fused step for D designs: the wrapper of ``csrc/fused_step.cu``.

    Args:
      w: [D, p, q] f32 weights (pad rows/columns zero).
      t_in: [D, p] f32 volley per design; a time >= that design's runtime
        ``t_max`` is silent.
      operands: [D, N_OPERANDS] f32 runtime design operands
        (``design_operands``); every ``t_max`` <= ``t_window``.
      t_window: evaluation length of the envelope.

    Returns:
      (w_new [D, p, q], y [D, q] f32 post-WTA winner times).

    CPU tensors take ``fused_step_padded_plain``; CUDA tensors launch the
    kernel (or raise).
    """
    tensors = (w, t_in, operands)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_step_padded_plain(
            w, t_in, operands, t_window=t_window, w_max=w_max,
            wta_k=wta_k, stabilize=stabilize,
        )
    if not all(t.is_cuda and t.device == w.device for t in tensors):
        raise ValueError(
            "fused_step_padded needs w, t_in and operands on one CUDA "
            "device (or all on the CPU), got "
            f"{[str(t.device) for t in tensors]}"
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(
            f"fused_step_padded needs float32 tensors, got "
            f"{[t.dtype for t in tensors]}"
        )
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("fused_step_padded needs contiguous tensors")
    if w.dim() != 3:
        raise ValueError(f"w must be [D, p, q], got {tuple(w.shape)}")
    d, p, q = w.shape
    if tuple(t_in.shape) != (d, p) or tuple(operands.shape) != (d, N_OPERANDS):
        raise ValueError(
            f"fused_step_padded: w {tuple(w.shape)} needs t_in {(d, p)} and "
            f"operands {(d, N_OPERANDS)}, got {tuple(t_in.shape)} and "
            f"{tuple(operands.shape)}"
        )
    if wta_k < 1:
        raise ValueError(f"wta_k must be >= 1, got {wta_k}")
    k = build.FUSED_STEP
    smem = k.smem_bytes(p, q)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_step_padded: a {p} x {q} envelope needs {smem} B of "
            f"shared memory (at most {build.MAX_SMEM_BYTES})"
        )
    w_out = torch.empty_like(w)
    y = torch.empty((d, q), dtype=torch.float32, device=w.device)
    if d == 0:
        return w_out, y
    fn = k.function()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        k.launches += 1
        rc = fn(w.data_ptr(), t_in.data_ptr(), operands.data_ptr(),
                w_out.data_ptr(), y.data_ptr(), d, p, q, int(t_window),
                int(w_max), int(wta_k), int(bool(stabilize)), _eps(w_max),
                stream)
    build.check_launch(k, rc)
    return w_out, y


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
    as the kernel); ``'cuda'`` calls ``fused_step_padded`` once per volley
    (D = 1), which launches the kernel on CUDA tensors.  Returns
    (params, ys) where ys is [epochs, N, q] int32 winner times when
    ``trace`` else None.  ``params`` is not modified.
    """
    check_fusable(cfg, lowering)
    w = params["w"].to(torch.float32).clone()
    n = x.shape[0]
    ys = []
    if lowering == "reference":
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
    else:
        operands = design_operands(
            [cfg.neuron.threshold], [cfg.t_max], [cfg.q], cfg.stdp.mu_capture,
            cfg.stdp.mu_backoff, cfg.stdp.mu_search, device=w.device,
        )
        xs = x.to(torch.float32).contiguous()
        w = w[None].contiguous()
        for _ in range(epochs):
            for i in range(n):
                w, y = fused_step_padded(
                    w, xs[i : i + 1], operands, t_window=cfg.t_max,
                    w_max=cfg.neuron.w_max, wta_k=cfg.wta.k,
                    stabilize=cfg.stdp.stabilizer == "half",
                )
                if trace:
                    ys.append(y[0])
        w = w[0]
    if not trace:
        return {"w": w}, None
    if not ys:
        return {"w": w}, torch.empty((epochs, n, cfg.q), dtype=TIME_DTYPE,
                                     device=w.device)
    return {"w": w}, torch.stack(ys).to(TIME_DTYPE).reshape(epochs, n, cfg.q)
