"""Online-softmax attention, causal or not: the CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Port of the JAX package's ``kernels/flash_attention.py`` (``_flash_kernel``
behind ``flash_attention_pallas``).  The public function keeps that
layout, [B, S, H, d], and computes what the TPU kernel computes on K and V
repeated to the query heads: q scaled by 1/sqrt(d), f32 scores with the
causal mask ``kv_pos <= q_pos``, a running max guarded for fully masked
rows, f32 probabilities and accumulator, ``acc / max(l, 1e-30)`` in q's
dtype.  Unlike the TPU kernel it takes grouped KV heads natively (query
head h reads KV head h // (Hq / Hkv), the grouping of
``layers._merge_gqa``), any Sq and Skv, and skips the key tiles past the
causal diagonal.

The kernel has two instantiations behind one entry point: bf16 runs both
products on the tensor cores (wgmma, with K and V tiles brought in by TMA),
the scale applied after the product in f32 and the probabilities split into
two bf16 parts for the PV product, so they keep about f32 accuracy, as the
TPU kernel's f32 probabilities do; f32 runs both products in f32 on the
CUDA cores.  Head dim 112 runs the bf16 kernel's D = 128 tiles on tensor
maps whose inner extent is 112 (TMA reads the missing columns as zeros; no
padded copy); head dim 224 (Zamba2's shared blocks) the D = 256 tiles on
tensor maps of inner extent 224, two stages of K and V.  MLA's expanded
prefill (Q and K at 192, V and O at 128, ``SPLIT_DIMS``) runs its own
instantiation: Q and K tiles of three 64-column boxes, V tiles and the
accumulator of two, four K/V stages; no padded copy of V.  K and V may be the
leading rows of a larger cache (a decode step's attention over the
filled positions).  The plain version is the LM's own ``layers.chunked_attention``
on the grouped view.  In bf16 that rounds the probabilities to bf16 before
the PV product, as the JAX model's attention does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.models import layers

# head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 112, 128, 224)
# (Q and K's head dim, V's and O's) pairs it is instantiated for besides:
# MLA's expanded prefill (DeepSeek-V3: 128 + 64 rope dims, v 128)
SPLIT_DIMS = ((192, 128),)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    *,
    kv_chunk: int = 1024,
    bf16_scores: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version: ``layers.chunked_attention`` on the grouped
    view.  q [B, Sq, Hq, d], k [B, Skv, Hkv, d], v [B, Skv, Hkv, dv] ->
    [B, Sq, Hq, dv]."""
    b, sq, hq, _ = q.shape
    out = layers.chunked_attention(
        layers._merge_gqa(q, k.shape[2]), k, v, causal=causal,
        kv_chunk=kv_chunk, bf16_scores=bf16_scores, scale=scale,
    )
    return out.reshape(b, sq, hq, v.shape[-1])


def _kv_rows(t: torch.Tensor) -> int:
    """Rows of the [B, R, H, d] buffer whose leading rows ``t`` [B, S, H, d]
    is (``buf[:, :S]``, a decode step's cache), or 0 where ``t`` is laid
    out otherwise."""
    b, s, h, d = t.shape
    if t.stride(3) != 1 or t.stride(2) != d or t.stride(1) != h * d:
        return 0
    rows, rem = divmod(t.stride(0), h * d) if b > 1 else (s, 0)
    return rows if not rem and rows >= s else 0


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Raise unless the kernel takes these tensors; return the rows of
    K's and V's buffer."""
    tensors = (q, k, v)
    dev = q.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(
            f"flash_attention needs q, k, v on one CUDA device (or all on "
            f"the CPU), got {[str(t.device) for t in tensors]}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention needs float32 or bfloat16 q, k, v of one "
            f"dtype, got {[t.dtype for t in tensors]}"
        )
    if any(t.dim() != 4 for t in tensors):
        raise ValueError(
            f"flash_attention needs q [B, Sq, Hq, d] and k, v [B, Skv, Hkv, "
            f"d], got {[tuple(t.shape) for t in tensors]}"
        )
    b, _, hq, d = q.shape
    dv = v.shape[-1]
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d
            or k.shape[2] == 0 or hq % k.shape[2]):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} needs k [{b}, Skv, Hkv, {d}] "
            f"and v [{b}, Skv, Hkv, dv] with Hkv dividing {hq}, got "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    if (d, dv) not in SPLIT_DIMS and (d != dv or d not in HEAD_DIMS):
        raise ValueError(f"flash_attention: head dims {d} / {dv} not in {HEAD_DIMS} "
                         f"(q, k and v alike) nor in {SPLIT_DIMS} (q and k, v)")
    rows = _kv_rows(k)
    if (not q.is_contiguous() or not rows or _kv_rows(v) != rows
            or any(t.data_ptr() % 16 for t in tensors)):
        raise ValueError("flash_attention needs a contiguous q and k, v each "
                         "contiguous or the leading rows of a contiguous "
                         "[B, R, Hkv, d] buffer, 16-byte aligned")
    return rows


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    scale: Optional[float] = None, kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of q [B, Sq, Hq, d] over k [B, Skv, Hkv, d] and v [B, Skv,
    Hkv, dv] -> [B, Sq, Hq, dv] in q's dtype (float32 or bfloat16), scores
    scaled by ``scale`` (default 1/sqrt(d)); dv == d in ``HEAD_DIMS``, or
    (d, dv) in ``SPLIT_DIMS``.  k and v may be the leading Skv rows of
    a contiguous [B, R, Hkv, d] cache (``cache[:, :n]``): the kernel reads
    them where they lie (the bf16 kernel's last key tile reads rows past
    Skv, masked: they must hold finite values, as a zeroed cache does).
    ``kv_len``, a one-element int32 tensor on q's device, gives the number
    of key rows to attend instead (1 <= kv_len <= Skv), read by the kernel
    itself: a decode step captured in a CUDA graph attends its cache's
    filled rows without a host-side length.

    CPU tensors take ``flash_attention_plain``; CUDA tensors launch the
    kernel, or raise.  The kernel has no backward: under autograd (grad
    mode on and an input that requires grad) it raises on either device,
    rather than return a result without a gradient; training takes
    ``layers.chunked_attention`` (``layers._attend`` decides).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: q, k or v requires grad with grad "
            "mode on; differentiate layers.chunked_attention instead, or call "
            "under torch.no_grad() / torch.inference_mode()"
        )
    if all(t.device.type == "cpu" for t in (q, k, v)):
        if kv_len is not None:
            n = int(kv_len.reshape(-1)[0])
            k, v = k[:, :n], v[:, :n]
        return flash_attention_plain(q, k, v, causal, scale=scale)
    kv_rows = _check_cuda(q, k, v)
    if kv_len is not None and (kv_len.device != q.device or kv_len.dtype != torch.int32
                               or kv_len.numel() != 1):
        raise ValueError("flash_attention: kv_len must be one int32 on q's device")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = q.new_empty((b, sq, hq, v.shape[-1]))
    if out.numel() == 0:
        return out
    kern = build.FLASH_ATTENTION
    fn = kern.function()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kern.launches += 1
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                sq, skv, build.ptr(kv_len), kv_rows, hq, hkv, d, v.shape[-1],
                int(bool(causal)),
                _DTYPES[q.dtype], 1.0 / math.sqrt(d) if scale is None else float(scale),
                stream)
    build.check_launch(kern, rc)
    return out
