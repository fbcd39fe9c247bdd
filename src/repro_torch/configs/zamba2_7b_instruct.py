"""Zamba2-7B-Instruct as published (Zyphra; arXiv:2411.15242;
https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json).

81 mamba2 layers (d_model 3584, d_inner 7168, 112 SSM heads of 64,
d_state 64, 2 groups of B and C, conv 4 with bias, chunk 256); two shared
attention + gated-GELU MLP blocks used in turn at the 13 hybrid layer ids,
each reading concat[h, x0] (7168 wide) with 32 MHA heads of dim 224, a
rank-128 adapter on the MLP's gate_up per application and a per-application
Linear(3584, 3584) into the next mamba layer's input; vocab 32000, tied
embeddings, RoPE theta 1e4 over the whole head, RMSNorm eps 1e-5.  The
port-only id: the JAX package has no twin of it (its ``zamba2-7b`` is the
simplified variant, ``configs/zamba2_7b.py``).
"""
from repro_torch.models.config import Zamba2Config

ARCH_ID = "zamba2-7b-instruct"

# the published ``hybrid_layer_ids`` (its ``layers_block_type``'s hybrid slots)
HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)


def full() -> Zamba2Config:
    return Zamba2Config(
        name=ARCH_ID, family="zamba2",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_head=224,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        hybrid_layer_ids=HYBRID_LAYER_IDS, num_mem_blocks=2,
        adapter_rank=128, ssm_groups=2, conv_bias=True, mlp_act="gelu",
        norm_eps=1e-5, dt_min=1e-3, time_step_max=0.1, time_step_floor=1e-4,
        max_position=4096, tie_embeddings=True, rope_theta=1e4,
    )


def smoke() -> Zamba2Config:
    """7 layers with hybrid ids 2 and 5, two mem blocks, 2 SSM groups,
    chunk 16, adapter rank 4, head dim 2 d_model / n_heads; float32."""
    return Zamba2Config(
        name=ARCH_ID + "-smoke", family="zamba2",
        n_layers=7, d_model=32, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=48, vocab_size=64, vocab_pad_to=64,
        ssm_state=8, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
        hybrid_layer_ids=(2, 5), num_mem_blocks=2, adapter_rank=4, ssm_groups=2,
        conv_bias=True, mlp_act="gelu", norm_eps=1e-5, dt_min=1e-3,
        max_position=256, tie_embeddings=True, rope_theta=1e4,
        dtype="float32", kv_chunk=16,
    )
