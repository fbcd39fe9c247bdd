"""StarCoder2-15B (arXiv:2402.19173, hf-verified): dense GQA + RoPE.

40L, d_model 6144, 48 heads (kv=4), d_ff 24576, vocab 49152.
"""
from repro_torch.models.config import ArchConfig

ARCH_ID = "starcoder2-15b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_head=128,
        d_ff=24576, vocab_size=49152, rope_theta=1e5, remat="full",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, dtype="float32", kv_chunk=16,
    )
