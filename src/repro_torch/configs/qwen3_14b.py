"""Qwen3-14B (hf:Qwen/Qwen3-8B family, hf-verified): dense, qk_norm, GQA.

40L, d_model 5120, 40 heads (kv=8), d_ff 17408, vocab 151936.
"""
from repro_torch.models.config import ArchConfig

ARCH_ID = "qwen3-14b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
        d_ff=17408, vocab_size=151936, qk_norm=True, rope_theta=1e6,
        remat="full",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, qk_norm=True, dtype="float32", kv_chunk=16,
    )
