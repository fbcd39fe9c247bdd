"""Zamba2-7B (arXiv:2411.15242) as the JAX package simplifies it: Mamba2
backbone + a shared attention block.

81 mamba2 blocks, d_model 3584, ssm_state 64; ONE shared attention+MLP
block (32 heads, kv=32, d_ff 14336) applied every 6 blocks with
per-application LoRA on W_q (rank 128), vocab 32000.  The port keeps it as
the JAX package has it (the parity tests hold the two together).  It
departs from the published model in: one shared block, not two used in
turn; the block reads h alone (head dim 112 over 3584), not concat[h, x0]
(head dim 224 over 7168, scores scaled by (224/2)^-1/2); LoRA on W_q, not
adapters on the MLP's gate_up; a residual inside the block, where the
published block's output goes through a per-application linear into the
next mamba layer's input only; the block every 6 layers, not at the
published hybrid layer ids; Mamba2 with one group, no conv bias and a plain
RMSNorm after the gate, where the published has 2 groups, a conv bias and
a grouped gated norm; SwiGLU, not gated GELU; chunk 128, not 256; an
untied head.  Zamba2 as published is the port-only id
``zamba2-7b-instruct`` (``configs/zamba2_7b_instruct.py``).
"""
from repro_torch.models.config import ArchConfig

ARCH_ID = "zamba2-7b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_head=112,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
        attn_every=6, shared_attn_lora_rank=128, remat="full",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=16, attn_every=2, shared_attn_lora_rank=4,
        dtype="float32", kv_chunk=16,
    )
