"""The Mamba2 SSD chunked scan of one layer in one launch: the CUDA kernel
``csrc/ssd_scan.cu``.

``models.ssm.ssd_chunked`` is the entry point: it calls ``ssd_scan`` for
CUDA tensors in bfloat16 or float32 when no gradient is required, and its
plain version, ``models.ssm.ssd_chunked_plain``, for everything else (CPU
tensors, float64, autograd: the kernel has no backward).  The kernel
computes what the plain version computes, with the same roundings: in
bf16 the decay mask, the scores C B^T (summed in f32) and x dt each rounded
to bf16 once, their products exact, and the state, its contributions and
y in f32; only the order of f32 sums differs (the kernel's source note
says how).  x, B and C are read where they lie (the conv output's split
views), through their strides.

The kernel is instantiated for the (state dim N, head dim, chunk tile)
triples of the port's SSM configurations, ``SHAPES`` (those of
``BF16_ONLY`` in bfloat16 alone: the f32 kernel's plan does not fit a
block's shared memory there); a chunk shorter
than its tile (a cached prefill of a prompt shorter than ``ssm_chunk``
runs one chunk of the prompt's length) runs in the smallest tile that
holds it, its rows past the chunk zero, as the plain version's pad is.
Any other shape raises.  The number of groups G of B and C is free (H a
multiple of G).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

# (N, head dim, chunk tile): zamba2-7b-instruct (G 2), granite-4.0-h-small
# (G 1), zamba2-7b and mamba2-370m (G 1), and the smoke configs (the
# instruct smoke's N 8, G 2)
SHAPES = ((64, 64, 256), (128, 64, 256), (64, 64, 128), (128, 64, 128), (16, 16, 16),
          (8, 16, 16))
# tiles with no float32 instantiation: the f32 plan (B, C, x and the state
# in f32) takes 365 KB of shared memory at (128, 64, 256), past the 227 KB
# a block may have
BF16_ONLY = ((128, 64, 256),)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chunk_tile(n_state: int, head_dim: int, chunk: int) -> int:
    """The instantiated chunk tile a scan of chunk ``chunk`` runs in: the
    smallest tile of (``n_state``, ``head_dim``) that holds it.  Raises
    ValueError where there is none."""
    tiles = sorted(t for n, d, t in SHAPES if (n, d) == (n_state, head_dim) and t >= chunk)
    if chunk < 1 or not tiles:
        raise ValueError(
            f"ssd_scan: no instantiation for N {n_state}, head dim {head_dim}, "
            f"chunk {chunk} (instantiated (N, head dim, chunk tile): {SHAPES})")
    return tiles[0]


def _aligned(t: torch.Tensor) -> bool:
    """Every row of t's last dim starts 16 bytes aligned."""
    step = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] % step == 0
            and all(s % step == 0 for s in t.stride()[:-1]))


def ssd_scan(
    x: torch.Tensor,  # [B, L, H, dh]
    dt: torch.Tensor,  # [B, L, H] float32
    A: torch.Tensor,  # [H] float32
    Bm: torch.Tensor,  # [B, L, N] or [B, L, G, N]
    Cm: torch.Tensor,  # as Bm
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, N, dh] float32
    compute_dtype: Optional[torch.dtype] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [B, L, H, dh] float32, final state [B, H, N, dh] float32) of the
    chunked SSD scan, ``ssd_chunked``'s result, in one kernel launch.

    x, B and C: one dtype, bfloat16 or float32, innermost stride 1, rows
    16-byte aligned (any other strides); ``compute_dtype`` (the dual form's
    operand dtype) None or x's dtype.  dt and A float32 (dt any strides).
    Every tensor on one CUDA device.  Raises ValueError, before anything
    is built or launched, for anything else.
    """
    if Bm.dim() == 3:
        Bm, Cm = Bm[:, :, None], Cm[:, :, None]
    tensors = [x, dt, A, Bm, Cm] + ([] if initial_state is None else [initial_state])
    dev = x.device
    if not all(t.device.type == "cuda" and t.device == dev for t in tensors):
        raise ValueError(
            f"ssd_scan needs every tensor on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}")
    if (x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype
            or compute_dtype not in (None, x.dtype)):
        raise ValueError(
            f"ssd_scan needs x, B and C in one of float32 or bfloat16 and the "
            f"compute dtype theirs, got {x.dtype}, {Bm.dtype}, {Cm.dtype}, "
            f"{compute_dtype}")
    if any(t.dtype != torch.float32 for t in tensors[1:3] + tensors[5:]):
        raise ValueError("ssd_scan needs dt, A and the initial state in float32")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd_scan needs x [B, L, H, dh] and B, C [B, L, G, N], got "
                         f"{tuple(x.shape)} and {tuple(Bm.shape)}")
    b, L, H, dh = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (b, L, H) or A.shape != (H,) or Cm.shape != Bm.shape
            or Bm.shape[:2] != (b, L) or G < 1 or H % G
            or (initial_state is not None and initial_state.shape != (b, H, N, dh))):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)} needs dt [{b}, {L}, {H}], A [{H}], B "
            f"and C [{b}, {L}, G, N] with G dividing {H}, an initial state "
            f"[{b}, {H}, N, {dh}]; got dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(Bm.shape)}, C {tuple(Cm.shape)}, state "
            f"{None if initial_state is None else tuple(initial_state.shape)}")
    tile = chunk_tile(N, dh, int(chunk))
    if x.dtype == torch.float32 and (N, dh, tile) in BF16_ONLY:
        raise ValueError(f"ssd_scan: no float32 instantiation for N {N}, head dim {dh}, "
                         f"chunk tile {tile} (bfloat16 only: {BF16_ONLY})")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)) or A.stride(0) != 1:
        raise ValueError("ssd_scan needs x, B and C with innermost stride 1 and A "
                         "contiguous")
    if not all(_aligned(t) for t in (x, Bm, Cm)):
        raise ValueError("ssd_scan needs the rows of x, B and C 16-byte aligned")

    y = torch.empty((b, L, H, dh), dtype=torch.float32, device=dev)
    s0 = None if initial_state is None else initial_state.contiguous()
    S = torch.empty((b, H, N, dh), dtype=torch.float32, device=dev)
    kern = build.SSD_SCAN
    fn = kern.function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kern.launches += 1
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                build.ptr(s0), y.data_ptr(), S.data_ptr(), b, L, H, G, N, dh, tile,
                int(chunk), *x.stride()[:3], *dt.stride(), *Bm.stride()[:3],
                *Cm.stride()[:3], _DTYPES[x.dtype], stream)
    build.check_launch(kern, rc)
    return y, S
