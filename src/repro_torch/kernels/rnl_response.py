"""Batched RNL firing times: the CUDA kernel ``csrc/rnl_fire.cu`` and its
plain PyTorch version.

Port of the JAX package's ``kernels/rnl_response.py`` (``_rnl_kernel``
behind ``rnl_fire_pallas``).  The TPU kernel decomposed integer weights
into one-hot value planes for its matrix unit; the CUDA kernel fires
int32 times >= 0 by a slope histogram and other times by the direct ramp
sum (see the source's note).  All compute

  t_fire[b, j] = first t < t_max with
                 sum_i min(relu(t - t_in[b, i]), rint(clamp(w_ij, 0, w_max)))
                 >= threshold,  else t_max

which, V being nondecreasing, is the TPU kernel's count of sub-threshold
cycles clamped to t_max.  Times at or past t_max are silent.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import TIME_DTYPE
from repro_torch.kernels import build, ref

# Dense transient budget of the plain version, in f32 elements per chunk.
_PLAIN_CHUNK_ELEMS = 1 << 24


def rnl_fire_plain(
    t_in: torch.Tensor, w: torch.Tensor, threshold: float, t_max: int, w_max: int
) -> torch.Tensor:
    """Plain PyTorch version: dense time evaluation on the rounded grid,
    in volley chunks that bound the [b, p, q, T] transient.
    [B, p] int32 or float32, [p, q] -> [B, q] int32."""
    wi = torch.round(torch.clamp(w.to(torch.float32), 0.0, float(w_max)))
    p, q = wi.shape
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, p * q * t_max))
    outs = [
        ref.rnl_fire_ref(t_in[s : s + step], wi, threshold, t_max)
        for s in range(0, t_in.shape[0], step)
    ]
    if not outs:
        return torch.empty((0, q), dtype=TIME_DTYPE, device=w.device)
    return torch.cat(outs)


def rnl_fire(
    t_in: torch.Tensor, w: torch.Tensor, threshold: float, t_max: int, w_max: int
) -> torch.Tensor:
    """Firing times of integer-grid RNL neurons.  [B, p], [p, q] -> [B, q].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise).  ``t_in`` is int32 or float32, ``w`` float32; the kernel
    reads int32 times as they are, and fires them by its slope histogram
    where none is negative (else, and for float32 times, by the ramp sum;
    the result is the same).  A column whose grid does not fit in shared
    memory beside a tile of volleys and the warps' rows runs in the
    kernel's device-memory layout.
    """
    if t_in.device.type == "cpu" and w.device.type == "cpu":
        return rnl_fire_plain(t_in, w, threshold, t_max, w_max)
    if not (t_in.is_cuda and w.is_cuda and t_in.device == w.device):
        raise ValueError(
            f"rnl_fire needs t_in and w on one CUDA device (or both on the "
            f"CPU), got {t_in.device} and {w.device}"
        )
    if t_in.dim() != 2 or w.dim() != 2 or t_in.shape[1] != w.shape[0]:
        raise ValueError(
            f"rnl_fire needs t_in [B, p] and w [p, q], got "
            f"{tuple(t_in.shape)} and {tuple(w.shape)}"
        )
    if t_in.dtype not in (torch.int32, torch.float32) or w.dtype != torch.float32:
        raise ValueError(
            f"rnl_fire needs int32/float32 t_in and float32 w, got "
            f"{t_in.dtype} and {w.dtype}"
        )
    if not w.is_contiguous():
        raise ValueError("rnl_fire needs a contiguous w")
    b, p = t_in.shape
    q = w.shape[1]
    ti = t_in.contiguous()  # int32 as it is: the kernel's slope form
    k = build.RNL_FIRE
    resident = k.resident(f"a {p} x {q} column", p, q, int(t_max))
    out = torch.empty((b, q), dtype=TIME_DTYPE, device=w.device)
    if b == 0 or q == 0:
        return out
    grid = build.grid_workspace(w, resident)
    fn = k.function()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        k.launches += 1
        rc = fn(ti.data_ptr(), w.data_ptr(), build.ptr(grid), int(resident),
                int(ti.dtype == TIME_DTYPE), out.data_ptr(), b, p, q,
                float(threshold), int(t_max), int(w_max), stream)
    build.check_launch(k, rc)
    return out
