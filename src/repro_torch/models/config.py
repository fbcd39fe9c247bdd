"""Architecture config schema for the LM-family architectures.

The port's own copy of the JAX package's ``ArchConfig`` (``models/config.py``
there), field for field, so ``dataclasses.asdict`` agrees across the two
packages.  ``repro_torch/configs/`` holds one module per arch with the
exact published hyper-parameters plus a reduced ``smoke()`` variant for
CPU tests.  Fields that steer XLA only (``remat``, ``unroll_scans``,
``q_chunk``) are kept so the schema stays one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'audio' | 'vlm'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 2.0
    # expert-compute implementation: 'gathered' (index-dispatch, per-expert
    # capacity, batched GEMMs — FLOP-exact) or 'ragged' (sort + ragged_dot;
    # XLA's default lowering is dense over all local groups — see §Perf).
    moe_impl: str = "gathered"
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- attention details ---
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope: bool = False  # qwen2-vl multimodal rope (3 position streams)
    # --- hybrid (zamba2): shared attention block applied every N ssm blocks
    attn_every: int = 0
    shared_attn_lora_rank: int = 0
    # --- encoder-decoder (whisper): n_layers == decoder layers
    encoder_decoder: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500  # audio frames after the (stubbed) conv frontend
    # --- numerics / memory policy ---
    dtype: str = "bfloat16"
    remat: str = "none"  # 'none' | 'full'
    optimizer: str = "adamw"  # 'adamw' | 'adafactor' (factored 2nd moment)
    # attention working-set policy: kv-chunked online-softmax attention
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # score dtype: fp32 scores are the conservative default; bf16 scores
    # (with fp32 running max/denominator/accumulator) halve the dominant
    # attention HBM traffic at <0.5% softmax error (§Perf granite iter4)
    attn_bf16_scores: bool = False
    # cost-analysis mode: unroll layer/chunk scans so XLA's HloCostAnalysis
    # (which visits while bodies ONCE) counts every layer.  The roofline
    # pipeline compiles 1- and 2-layer unrolled variants and extrapolates;
    # the real (scanned) compile provides memory analysis + sharding proof.
    unroll_scans: bool = False

    # vocab is padded to this multiple so the vocab dim shards cleanly over
    # the model axis (Megatron-style); loss masks the padded logit columns.
    vocab_pad_to: int = 256

    def __post_init__(self):
        if self.d_head is None and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    # ---- analytics used by roofline + forecasting -------------------------
    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        n = V * D  # embedding
        n += V * D  # lm head (untied)
        Hq = (self.n_heads or 0) * (self.d_head or 0)
        Hkv = (self.n_kv_heads or 0) * (self.d_head or 0)
        attn = D * Hq + 2 * D * Hkv + Hq * D
        dense_mlp = 3 * D * F  # SwiGLU
        if self.family == "moe":
            mlp = self.n_experts * 3 * D * self.d_ff
        else:
            mlp = dense_mlp
        if self.family == "ssm":
            n += L * self._ssm_block_params()
        elif self.family == "hybrid":
            n_attn_apps = (L + self.attn_every - 1) // self.attn_every if self.attn_every else 0
            n += L * self._ssm_block_params()
            n += attn + dense_mlp  # one shared block
            n += n_attn_apps * self._lora_params()
        elif self.family == "audio":
            n += self.enc_layers * (attn + dense_mlp)  # encoder
            n += L * (2 * attn + dense_mlp)  # decoder: self + cross attn
        else:
            n += L * (attn + mlp)
        return n

    def _ssm_block_params(self) -> int:
        D, Di, Ns = self.d_model, self.d_inner, self.ssm_state
        H = self.ssm_heads
        in_proj = D * (2 * Di + 2 * Ns + H)  # z, x, B, C, dt
        out_proj = Di * D
        return in_proj + out_proj + Di + 2 * H  # conv-less variant + A, D gains

    def _lora_params(self) -> int:
        r = self.shared_attn_lora_rank
        if not r:
            return 0
        D = self.d_model
        Hq = self.n_heads * self.d_head
        Hkv = self.n_kv_heads * self.d_head
        return r * (2 * D + Hq + 2 * Hkv + D) // 1

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        total = self.param_count()
        expert = self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
        active = self.n_layers * self.top_k * 3 * self.d_model * self.d_ff
        return total - expert + active

    def model_flops_per_token(self) -> float:
        """6 * N(_active) — the §Roofline MODEL_FLOPS convention."""
        return 6.0 * self.active_param_count()
