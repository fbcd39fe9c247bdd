"""DeepSeek-Coder-33B (arXiv:2401.14196, hf-verified): llama-arch dense GQA.

62L, d_model 7168, 56 heads (kv=8), d_ff 19200, vocab 32256.
"""
from repro_torch.models.config import ArchConfig

ARCH_ID = "deepseek-coder-33b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
        d_ff=19200, vocab_size=32256, rope_theta=1e5, remat="full",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, dtype="float32", kv_chunk=16,
    )
