"""Qwen2-VL-7B backbone (arXiv:2409.12191, hf-verified): M-RoPE decoder.

28L, d_model 3584, 28 heads (kv=4), d_ff 18944, vocab 152064.  The vision
frontend (dynamic-resolution patch embed) is a stub: callers pass token ids
and, optionally, the 3-stream M-RoPE position ids.
"""
from repro_torch.models.config import ArchConfig

ARCH_ID = "qwen2-vl-7b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_head=128,
        d_ff=18944, vocab_size=152064, mrope=True, rope_theta=1e6,
        remat="full",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, mrope=True, dtype="float32", kv_chunk=16,
    )
