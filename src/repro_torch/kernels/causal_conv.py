"""The Mamba2 layer's depthwise causal conv, its bias and SiLU in one
launch: the CUDA kernel ``csrc/causal_conv.cu``.

``models.ssm._causal_conv`` is the entry point: it calls ``causal_conv``
for CUDA tensors in bfloat16 or float32 when no gradient is required, and
its plain version, ``models.ssm._causal_conv_plain``, for everything else
(CPU tensors, float64, autograd: the kernel has no backward).  The kernel
computes what the plain version computes, bit for bit: the four taps'
products and sums in f32 in the plain version's order, each rounded once,
the bias, PyTorch's f32 SiLU and the rounding to the model's dtype.  u is
read where it lies (the x | B | C columns of the in_proj output), through
its strides.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

WIDTH = 4  # the kernel's taps: models.ssm.CONV_K
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def vectorized(*tensors: Optional[torch.Tensor]) -> bool:
    """Every tensor (None skipped) starts 8 bytes aligned and every stride
    but the innermost, and the last dim, are whole 8-byte words: the
    kernel's 8-byte accesses (else it takes one element a thread)."""
    step = 8 // tensors[0].element_size()
    return all(t.data_ptr() % 8 == 0 and t.shape[-1] % step == 0
               and all(s % step == 0 for s in t.stride()[:-1])
               for t in tensors if t is not None)


def causal_conv(
    u: torch.Tensor,  # [B, L, C]
    w: torch.Tensor,  # [WIDTH, C]
    state: Optional[torch.Tensor] = None,  # [B, WIDTH - 1, C]
    bias: Optional[torch.Tensor] = None,  # [C]
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, L, C], new_state [B, WIDTH - 1, C]), both contiguous in u's
    dtype: ``_causal_conv``'s result in one kernel launch.

    u: bfloat16 or float32, innermost stride 1 (any other strides), L >= 1;
    w, the state and the bias of u's dtype.  Every tensor on one CUDA
    device.  Raises ValueError, before anything is built or launched, for
    anything else.
    """
    tensors = [t for t in (u, w, state, bias) if t is not None]
    dev = u.device
    if not all(t.device.type == "cuda" and t.device == dev for t in tensors):
        raise ValueError(
            f"causal_conv needs every tensor on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}")
    if u.dtype not in _DTYPES or any(t.dtype != u.dtype for t in tensors):
        raise ValueError(
            f"causal_conv needs u in float32 or bfloat16 and w, the state and "
            f"the bias in u's dtype, got {[t.dtype for t in tensors]}")
    if u.dim() != 3 or u.shape[1] < 1 or u.shape[0] < 1 or u.shape[2] < 1:
        raise ValueError(f"causal_conv needs u [B, L >= 1, C], got {tuple(u.shape)}")
    b, L, C = u.shape
    if (w.shape != (WIDTH, C) or (bias is not None and bias.shape != (C,))
            or (state is not None and state.shape != (b, WIDTH - 1, C))):
        raise ValueError(
            f"causal_conv: u {tuple(u.shape)} needs w [{WIDTH}, {C}], a bias [{C}] "
            f"and a state [{b}, {WIDTH - 1}, {C}]; got w {tuple(w.shape)}, bias "
            f"{None if bias is None else tuple(bias.shape)}, state "
            f"{None if state is None else tuple(state.shape)}")
    if u.stride(-1) != 1:
        raise ValueError("causal_conv needs u with innermost stride 1")
    if b > 65535 or -(-L // 64) > 65535:
        raise ValueError(f"causal_conv takes B <= 65,535 and L <= 4,194,240, got "
                         f"{b} and {L}")

    w = w.contiguous()
    state = None if state is None else state.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((b, L, C), dtype=u.dtype, device=dev)
    new_state = torch.empty((b, WIDTH - 1, C), dtype=u.dtype, device=dev)
    vec = vectorized(u, w, state, bias)
    kern = build.CAUSAL_CONV
    fn = kern.function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kern.launches += 1
        rc = fn(u.data_ptr(), build.ptr(state), w.data_ptr(), build.ptr(bias),
                out.data_ptr(), new_state.data_ptr(), b, L, C, u.stride(0), u.stride(1),
                _DTYPES[u.dtype], int(vec), stream)
    build.check_launch(kern, rc)
    return out, new_state
