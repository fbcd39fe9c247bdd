"""Mamba2-370m (arXiv:2405.21060): pure SSD, attention-free.

48L, d_model 1024, ssm_state 128, vocab 50280.
"""
from repro_torch.models.config import ArchConfig

ARCH_ID = "mamba2-370m"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="ssm",
        n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_head=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
        remat="full",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_head=0,
        d_ff=0, vocab_size=256, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=16, dtype="float32",
    )
