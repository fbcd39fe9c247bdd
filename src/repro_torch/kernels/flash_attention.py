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
padded copy).  The plain version is the LM's own ``layers.chunked_attention``
on the grouped view.  In bf16 that rounds the probabilities to bf16 before
the PV product, as the JAX model's attention does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.models import layers

# head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    *,
    kv_chunk: int = 1024,
    bf16_scores: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version: ``layers.chunked_attention`` on the grouped
    view.  q [B, Sq, Hq, d], k/v [B, Skv, Hkv, d] -> [B, Sq, Hq, d]."""
    b, sq, hq, d = q.shape
    out = layers.chunked_attention(
        layers._merge_gqa(q, k.shape[2]), k, v, causal=causal,
        kv_chunk=kv_chunk, bf16_scores=bf16_scores,
    )
    return out.reshape(b, sq, hq, d)


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or k.shape[2] == 0 or hq % k.shape[2]):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} needs k and v "
            f"[{b}, Skv, Hkv, {d}] with Hkv dividing {hq}, got "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention needs contiguous, 16-byte aligned "
                         "q, k and v")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Attention of q [B, Sq, Hq, d] over k, v [B, Skv, Hkv, d] ->
    [B, Sq, Hq, d] in q's dtype (float32 or bfloat16).

    CPU tensors take ``flash_attention_plain``; CUDA tensors launch the
    kernel, or raise.
    """
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal)
    _check_cuda(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    kern = build.FLASH_ATTENTION
    fn = kern.function()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kern.launches += 1
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                sq, skv, hq, hkv, d, int(bool(causal)), _DTYPES[q.dtype],
                1.0 / math.sqrt(d), stream)
    build.check_launch(kern, rc)
    return out
