"""Granite-4.0-H-Small as published (IBM, 32B-A9B;
https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json,
model type ``granitemoehybrid``).

40 layers, d_model 4096: 36 Mamba2 mixers (128 heads of 64, d_state 128,
1 group, conv 4 with bias, chunk 256, dt not clamped) and, at layers 5,
15, 25 and 35, GQA attention (32 query and 8 KV heads of 128, no position
embedding, scores scaled by 1/128); every layer then runs a dropless MoE
of 72 SwiGLU experts of width 768, top 10, and a shared SwiGLU expert of
width 1536.  muP: embeddings x12, each residual branch x0.22, logits / 16.
Vocab 100352, tied embeddings, RMSNorm eps 1e-5.  A port-only id: the JAX
package has no twin of it.
"""
from repro_torch.models.config import GraniteMoeHybridConfig

ARCH_ID = "granite-4.0-h-small"

# the published ``layer_types``' attention slots
ATTN_LAYER_IDS = (5, 15, 25, 35)


def full() -> GraniteMoeHybridConfig:
    return GraniteMoeHybridConfig(
        name=ARCH_ID, family="granite4h",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=768, vocab_size=100352, n_experts=72, top_k=10,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        attn_layer_ids=ATTN_LAYER_IDS, shared_d_ff=1536,
        embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=0.0078125, logits_scaling=16.0,
        norm_eps=1e-5, max_position=131072, rope_theta=1e4,
    )


def smoke() -> GraniteMoeHybridConfig:
    """4 layers with attention at id 2 (GQA 4:2, head dim 16), 8 experts
    top 3 of width 24, a shared expert of width 40, 8 SSM heads of 16 with
    d_state 16 and chunk 16; float32."""
    return GraniteMoeHybridConfig(
        name=ARCH_ID + "-smoke", family="granite4h",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=24, vocab_size=128, vocab_pad_to=64, n_experts=8, top_k=3,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
        attn_layer_ids=(2,), shared_d_ff=40,
        embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=1.0 / 16, logits_scaling=16.0,
        norm_eps=1e-5, max_position=256, rope_theta=1e4,
        dtype="float32", kv_chunk=16,
    )
