"""Kanana-2-30B-A3B-Instruct as published (Kakao, 30B-A3B;
https://huggingface.co/kakaocorp/kanana-2-30b-a3b-instruct-2601/blob/main/config.json,
model type ``deepseek_v3``).

48 layers, d_model 2048, each latent attention (MLA) without q_lora: 32
heads, q and k of 128 + 64 (the 64 rope dims, pairs rotated, theta 1e6),
v of 128, a latent of 512 + 64 a position; then layer 0 a SwiGLU of width
6144 and layers 1-47 a MoE of 128 SwiGLU experts of width 768, top 6 of
the sigmoid scores plus a correction bias, the gates normalised and times
2.448, and two shared experts (one SwiGLU of width 1536).  Vocab 128256,
untied embeddings, RMSNorm eps 1e-6, context 32768.  A port-only id: the
JAX package has no twin of it.
"""
from repro_torch.models.config import DeepseekV3Config

ARCH_ID = "kanana-2-30b-a3b-instruct"


def full() -> DeepseekV3Config:
    return DeepseekV3Config(
        name=ARCH_ID, family="deepseek_v3",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=192,
        d_ff=6144, vocab_size=128256, n_experts=128, top_k=6,
        kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        first_k_dense=1, moe_d_ff=768, n_shared_experts=2, routed_scaling=2.448,
        norm_eps=1e-6, max_position=32768, rope_theta=1e6,
    )


def smoke() -> DeepseekV3Config:
    """3 layers (one dense), d_model 64, 2 heads at the published head
    widths (128 + 64, v 128: the flash kernel's 192 / 128 instantiation),
    a latent of 32 + 64, 8 experts top 3 of width 24, one shared expert of
    width 24, a dense width of 96; float32."""
    return DeepseekV3Config(
        name=ARCH_ID + "-smoke", family="deepseek_v3",
        n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, d_head=192,
        d_ff=96, vocab_size=128, vocab_pad_to=64, n_experts=8, top_k=3,
        kv_lora_rank=32, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        first_k_dense=1, moe_d_ff=24, n_shared_experts=1, routed_scaling=2.448,
        norm_eps=1e-6, max_position=256, rope_theta=1e6, dtype="float32", kv_chunk=16,
    )
