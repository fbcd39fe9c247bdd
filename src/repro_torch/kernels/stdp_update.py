"""Expected-mode STDP update of one volley: the CUDA kernel
``csrc/stdp_update.cu`` and its plain PyTorch version.

Port of the JAX package's ``kernels/stdp_update.py`` (``_stdp_kernel``
behind ``stdp_update_pallas``).  Both compute, per synapse (i, j), the
capture, backoff and search cases of the paper's expected STDP with the
optional half stabilizer, clamped to [0, w_max], in the form XLA compiles
the TPU kernel to (``ref.stdp_ref(..., compiled=True)``).  Spike times
may be int32 or float32; they are cast to float32 before comparing, as
the TPU wrapper does.  The TPU kernel padded (p, q) to its 8 x 128 tiles
with silent entries, which leave weights untouched; the CUDA kernel runs
a flat grid and needs no padding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_column import _eps


def stdp_update_plain(
    w: torch.Tensor,
    x_times: torch.Tensor,
    y_times: torch.Tensor,
    mu_capture: float,
    mu_backoff: float,
    mu_search: float,
    w_max: int,
    t_max: int,
    stabilize: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version: ``ref.stdp_ref(..., compiled=True)`` on
    float32 times.  w: [p, q]; x_times: [p]; y_times: [q] -> new w."""
    return ref.stdp_ref(
        w.to(torch.float32), x_times.to(torch.float32),
        y_times.to(torch.float32), mu_capture, mu_backoff, mu_search, w_max,
        t_max, stabilize=stabilize, compiled=True,
    )


def stdp_update(
    w: torch.Tensor,
    x_times: torch.Tensor,
    y_times: torch.Tensor,
    mu_capture: float,
    mu_backoff: float,
    mu_search: float,
    w_max: int,
    t_max: int,
    stabilize: bool = True,
) -> torch.Tensor:
    """Fused expected STDP update.  w: [p, q] f32; x: [p]; y: [q] -> new w.

    CPU tensors take ``stdp_update_plain``; CUDA tensors launch the kernel
    (or raise).  Times are int32 or float32 (a time >= ``t_max`` is
    silent), each vector contiguous; the kernel reads them as they are.
    ``w`` is not modified.
    """
    tensors = (w, x_times, y_times)
    if all(t.device.type == "cpu" for t in tensors):
        return stdp_update_plain(w, x_times, y_times, mu_capture, mu_backoff,
                                 mu_search, w_max, t_max, stabilize)
    dev = w.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(
            f"stdp_update needs w, x and y on one CUDA device (or all on "
            f"the CPU), got {[str(t.device) for t in tensors]}"
        )
    if w.dim() != 2 or tuple(x_times.shape) != (w.shape[0],) or tuple(
        y_times.shape
    ) != (w.shape[1],):
        raise ValueError(
            f"stdp_update needs w [p, q], x [p] and y [q], got "
            f"{tuple(w.shape)}, {tuple(x_times.shape)} and "
            f"{tuple(y_times.shape)}"
        )
    if w.dtype != torch.float32 or any(
        t.dtype not in (torch.int32, torch.float32) for t in (x_times, y_times)
    ):
        raise ValueError(
            f"stdp_update needs float32 w and int32/float32 times, got "
            f"{[t.dtype for t in tensors]}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("stdp_update needs contiguous w, x and y")
    p, q = w.shape
    w_out = torch.empty_like(w)
    if p == 0 or q == 0:
        return w_out
    k = build.STDP_UPDATE
    fn = k.function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        k.launches += 1
        rc = fn(w.data_ptr(), x_times.data_ptr(), y_times.data_ptr(),
                w_out.data_ptr(), p, q, float(t_max), float(mu_capture),
                float(mu_backoff), float(mu_search), int(w_max),
                int(bool(stabilize)), _eps(w_max),
                int(x_times.dtype == torch.int32),
                int(y_times.dtype == torch.int32), stream)
    build.check_launch(k, rc)
    return w_out
