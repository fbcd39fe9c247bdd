"""OLMoE-1B-7B (arXiv:2409.02060, hf-verified).

16L, d_model 2048, 16 heads (kv=16 -> MHA), 64 experts top-8, expert
d_ff 1024, vocab 50304.
"""
from repro_torch.models.config import ArchConfig

ARCH_ID = "olmoe-1b-7b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1024, vocab_size=50304, n_experts=64, top_k=8,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=32, vocab_size=256, n_experts=8, top_k=2,
        dtype="float32", kv_chunk=16, moe_capacity_factor=4.0,
    )
