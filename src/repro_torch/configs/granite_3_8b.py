"""Granite-3 8B (hf:ibm-granite/granite-3.0 family, hf-verified): dense GQA.

40L, d_model 4096, 32 heads (kv=8), d_ff 12800, vocab 49155.
"""
from repro_torch.models.config import ArchConfig

ARCH_ID = "granite-3-8b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=12800, vocab_size=49155, remat="full",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, dtype="float32", kv_chunk=16,
    )
