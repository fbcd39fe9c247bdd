"""The Mamba2 mixer's decode step, from a token's in_proj output to the
input of out_proj, in two launches: the CUDA kernels ``csrc/ssm_step.cu``.

``models.ssm._one_token`` is the entry point: it calls ``ssm_step`` for
CUDA tensors in bfloat16 or float32 when no gradient is required, and its
plain version, ``models.ssm._one_token_plain``, for everything else (CPU
tensors, float64, autograd: the kernels have no backward).  The kernels
make the plain version's roundings: the conv step (taps, bias, SiLU,
rounding to the dtype), the step sizes, the decay and the new state S' in
the plain version's order, bit for bit; y = C . S' and the norm's mean in
their own order (``repro_torch.testing.ssm_step`` gives the bound).  The
states passed in are read, never written: the new ones are fresh tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

WIDTH = 4  # the conv's taps: models.ssm.CONV_K
NORMS = ("grouped", "rmsnorm")  # models.ssm._gated_norm's two forms
THREADS = 128  # csrc/ssm_step.cu's kThreads
MAX_SMEM_BYTES = 48 * 1024  # dynamic shared memory without an opt-in
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(state: int, head_dim: int) -> int:
    """Shared memory ``ssm_step_kernel`` asks for (``launch`` in the
    source): x, the group's B and C, and one row of partial sums a row
    group."""
    return 4 * (head_dim + 2 * state + (THREADS // (head_dim // 4)) * head_dim)


def ssm_step(
    proj: torch.Tensor,  # [B, 1, Di + C + H]: z | x B C | dt
    conv: torch.Tensor,  # [B, WIDTH - 1, C]
    S: torch.Tensor,  # [B, H, N, dh], f32
    conv_w: torch.Tensor,  # [WIDTH, C]
    conv_b: Optional[torch.Tensor],  # [C]
    dt_bias: torch.Tensor,  # [H], f32
    A_log: torch.Tensor,  # [H], f32
    D: torch.Tensor,  # [H], f32
    gamma: torch.Tensor,  # [Di]
    *,
    groups: int,
    dt_min: float,
    norm: str,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y [B, 1, Di] in proj's dtype, the new conv state [B, WIDTH - 1, C],
    the new S [B, H, N, dh]): ``_one_token``'s result before out_proj, in
    two launches.  C = Di + 2 ``groups`` N, Di = H dh.  ``dt_min`` 0 leaves
    softplus(dt) unclamped; ``norm`` is one of ``NORMS``, over ``groups``
    groups ('grouped') or the whole Di ('rmsnorm'), with ``eps``.

    proj: bfloat16 or float32, innermost stride 1; the conv state, the
    taps, the bias and gamma of proj's dtype; S, dt_bias, A_log and D
    float32, S contiguous and 16 bytes aligned; head dim a multiple of 4,
    at most 512.  Every tensor on one CUDA device.  Raises ValueError,
    before anything is built or launched, for anything else.
    """
    tensors = [t for t in (proj, conv, S, conv_w, conv_b, dt_bias, A_log, D, gamma)
               if t is not None]
    dev = proj.device
    if not all(t.device.type == "cuda" and t.device == dev for t in tensors):
        raise ValueError(
            f"ssm_step needs every tensor on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}")
    dtype = proj.dtype
    model = [t for t in (conv, conv_w, conv_b, gamma) if t is not None]
    if (dtype not in _DTYPES or any(t.dtype != dtype for t in model)
            or any(t.dtype != torch.float32 for t in (S, dt_bias, A_log, D))):
        raise ValueError(
            f"ssm_step needs proj in float32 or bfloat16, the conv state, taps, bias "
            f"and gamma in proj's dtype, and S, dt_bias, A_log and D in float32; got "
            f"{[t.dtype for t in tensors]}")
    if norm not in NORMS:
        raise ValueError(f"ssm_step: norm {norm!r} is not one of {NORMS}")
    if S.dim() != 4 or proj.dim() != 3 or proj.shape[1] != 1:
        raise ValueError(f"ssm_step needs S [B, H, N, dh] and proj [B, 1, W], got S "
                         f"{tuple(S.shape)} and proj {tuple(proj.shape)}")
    b, H, N, dh = S.shape
    if b > 65535 or dh % 4 or not 4 <= dh <= 4 * THREADS:
        raise ValueError(f"ssm_step takes B <= 65,535 and a head dim that is a "
                         f"multiple of 4 in [4, {4 * THREADS}], got {b} and {dh}")
    di = H * dh
    c = di + 2 * groups * N
    want = {"proj": (b, 1, di + c + H), "conv": (b, WIDTH - 1, c), "conv_w": (WIDTH, c),
            "conv_b": (c,), "dt_bias": (H,), "A_log": (H,), "D": (H,), "gamma": (di,)}
    got = {"proj": proj, "conv": conv, "conv_w": conv_w, "conv_b": conv_b,
           "dt_bias": dt_bias, "A_log": A_log, "D": D, "gamma": gamma}
    bad = {k: tuple(t.shape) for k, t in got.items() if t is not None and t.shape != want[k]}
    if groups < 1 or H % groups or bad:
        raise ValueError(
            f"ssm_step: S {tuple(S.shape)} with {groups} groups needs {want}; got {bad}")
    if smem_bytes(N, dh) > MAX_SMEM_BYTES:
        raise ValueError(f"ssm_step: N {N}, head dim {dh} need {smem_bytes(N, dh)} B of "
                         f"shared memory, past {MAX_SMEM_BYTES}")
    if proj.stride(-1) != 1:
        raise ValueError("ssm_step needs proj with innermost stride 1")
    if not S.is_contiguous() or S.data_ptr() % 16:
        raise ValueError("ssm_step needs S contiguous and 16 bytes aligned (the "
                         "kernel's accesses)")

    conv = conv.contiguous()
    conv_w, gamma = conv_w.contiguous(), gamma.contiguous()
    conv_b = None if conv_b is None else conv_b.contiguous()
    dt_bias, A_log, D = dt_bias.contiguous(), A_log.contiguous(), D.contiguous()
    y = torch.empty((b, 1, di), dtype=dtype, device=dev)
    new_conv = torch.empty((b, WIDTH - 1, c), dtype=dtype, device=dev)
    new_S = torch.empty((b, H, N, dh), dtype=torch.float32, device=dev)
    u = torch.empty((b, di), dtype=torch.float32, device=dev)
    ss = torch.empty((b, H), dtype=torch.float32, device=dev)
    kern = build.SSM_STEP
    fn = kern.function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kern.launches += 2
        rc = fn(proj.data_ptr(), conv.data_ptr(), S.data_ptr(), conv_w.data_ptr(),
                build.ptr(conv_b), dt_bias.data_ptr(), A_log.data_ptr(), D.data_ptr(),
                gamma.data_ptr(), y.data_ptr(), new_conv.data_ptr(), new_S.data_ptr(),
                u.data_ptr(), ss.data_ptr(), b, proj.stride(0), H, groups, N, dh,
                int(bool(dt_min)), float(dt_min), groups if norm == "grouped" else 1,
                int(norm == "rmsnorm"), float(eps), _DTYPES[dtype], stream)
    build.check_launch(kern, rc)
    return y, new_conv, new_S
