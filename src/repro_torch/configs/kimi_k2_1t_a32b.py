"""Kimi K2 — trillion-parameter MoE (arXiv:2501.kimi2, paper-table).

61L, d_model 7168, 64 q heads (GQA kv=8, d_head 112), 384 experts top-8
with d_ff(expert)=2048, vocab 163840.  The optimizer field names the
factored-second-moment optimizer (adafactor) the JAX package trains it with.
"""
from repro_torch.models.config import ArchConfig

ARCH_ID = "kimi-k2-1t-a32b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=112,
        d_ff=2048, vocab_size=163840, n_experts=384, top_k=8,
        optimizer="adafactor", remat="full",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=32, vocab_size=256, n_experts=8, top_k=2,
        dtype="float32", kv_chunk=16, moe_capacity_factor=4.0,
    )
