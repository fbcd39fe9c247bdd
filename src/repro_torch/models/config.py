"""Architecture config schema for the LM-family architectures.

The port's own copy of the JAX package's ``ArchConfig`` (``models/config.py``
there), field for field, so ``dataclasses.asdict`` agrees across the two
packages.  ``repro_torch/configs/`` holds one module per arch with the
exact published hyper-parameters plus a reduced ``smoke()`` variant for
CPU tests.  ``remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``); fields that steer XLA only
(``unroll_scans``, ``q_chunk``) are kept so the schema stays one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'audio' | 'vlm' | 'zamba2' | 'granite4h'
    # | 'deepseek_v3'
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

    # Knobs of the SSM block, the final norm and the head that the
    # published Zamba2 (``Zamba2Config`` below, family 'zamba2') sets as
    # fields; here they are class attributes, not fields, so every other
    # config keeps its fields, its ``asdict`` and its numerics.
    ssm_groups = 1  # groups of the SSM's B and C
    conv_bias = False  # the SSM conv's bias
    dt_min = 0.0  # softplus(dt) clamped below (0: not clamped)
    # the SSM's output norm: 'rmsnorm' (y * silu(z) in the model's dtype,
    # then RMSNorm, the JAX package's) or 'grouped' (norm(y * silu(z)) in
    # f32 over ssm_groups groups, ``Zamba2RMSNormGated``)
    ssm_norm = "rmsnorm"
    norm_eps = 1e-6  # the final norm's
    tie_embeddings = False
    logits_scaling = 1.0  # the logits divided by it (Granite 4.0-H: 16)

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


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ArchConfig):
    """Zamba2 as published (``transformers``' ``Zamba2ForCausalLM``,
    arXiv:2411.15242), beside the JAX package's simplified ``zamba2-7b``.

    Mamba2 layers with ``ssm_groups`` groups of B and C, a conv with bias
    and a grouped gated RMSNorm; ``num_mem_blocks`` shared attention + MLP
    blocks, used in turn at ``hybrid_layer_ids``.  A shared block reads
    concat[h, x0] (width 2 d_model, x0 the token embeddings), attends with
    head dim ``d_head`` = 2 d_model / n_heads over it (scores scaled by
    (d_head / 2)^-1/2, RoPE over the whole head, halves rotated), maps back
    to d_model, and runs a gated-GELU MLP whose gate_up has a rank
    ``adapter_rank`` adapter per application.  Each application's own
    Linear(d_model, d_model) of the block's output is added to the input
    of the mamba layer at that id only.  ``dt_min`` clamps softplus(dt)
    from below (``time_step_min``, as ``Zamba2MambaMixer.torch_forward``);
    ``time_step_max`` and ``time_step_floor`` only shape the init of
    dt_bias.  Embeddings tied.  The family is 'zamba2': the model code
    dispatches on it.
    """
    hybrid_layer_ids: tuple = ()
    num_mem_blocks: int = 2
    adapter_rank: int = 128
    ssm_groups: int = 2
    conv_bias: bool = True
    mlp_act: str = "gelu"
    norm_eps: float = 1e-5
    dt_min: float = 1e-3
    time_step_max: float = 0.1
    time_step_floor: float = 1e-4
    max_position: int = 4096
    tie_embeddings: bool = True
    ssm_norm: str = "grouped"

    def __post_init__(self):
        super().__post_init__()
        if self.family != "zamba2":
            raise ValueError(f"a Zamba2Config is of family 'zamba2', not {self.family!r}")

    @property
    def n_apps(self) -> int:
        return len(self.hybrid_layer_ids)

    def param_count(self) -> int:
        """Parameters as published: tied embedding, 81 mamba layers, the
        shared blocks, the per-application adapters and linears."""
        D, Di, F, G = self.d_model, self.d_inner, self.d_ff, self.ssm_groups
        N, H, r = self.ssm_state, self.ssm_heads, self.adapter_rank
        conv = Di + 2 * G * N
        mamba = (D * (Di + conv + H) + conv * (4 + int(self.conv_bias)) + 3 * H
                 + Di + Di * D + D)
        A = 2 * D
        shared = (A * 3 * self.n_heads * self.d_head + self.n_heads * self.d_head * D
                  + D * 2 * F + F * D + A + D)
        apps = self.n_apps * (D * r + r * 2 * F + D * D)
        return (self.vocab_size * D + self.n_layers * mamba + self.num_mem_blocks * shared
                + apps + D)

    def active_param_count(self) -> int:
        return self.param_count()


@dataclasses.dataclass(frozen=True)
class GraniteMoeHybridConfig(ArchConfig):
    """Granite 4.0-H as published (``transformers``'
    ``GraniteMoeHybridForCausalLM``, model type ``granitemoehybrid``).

    ``n_layers`` decoder layers, each a mixer then a feed-forward block:
    the mixer is a Mamba2 layer (``ssm_heads`` heads of ``ssm_head_dim``,
    state ``ssm_state``, ``ssm_groups`` groups, a conv with bias, chunk
    ``ssm_chunk``, softplus(dt) not clamped, the gated RMSNorm over
    d_inner / ``ssm_groups`` in f32) or, at ``attn_layer_ids``, GQA
    attention (``n_heads`` query and ``n_kv_heads`` KV heads of
    ``d_head``, no position embedding, scores scaled by
    ``attention_multiplier``); the feed-forward block is a dropless MoE of
    ``n_experts`` SwiGLU experts of width ``d_ff``, top ``top_k`` with a
    softmax over the top-k logits, plus a shared SwiGLU expert of width
    ``shared_d_ff``.  Each branch is added to the residual times
    ``residual_multiplier``; the embeddings are scaled by
    ``embedding_multiplier`` and the logits divided by ``logits_scaling``
    (muP).  Embeddings tied.  The family is 'granite4h': the model code
    dispatches on it (``models/granite4h.py``).
    """
    attn_layer_ids: tuple = ()
    shared_d_ff: int = 1536
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    attention_multiplier: float = 1.0 / 128
    logits_scaling: float = 16.0
    conv_bias: bool = True
    norm_eps: float = 1e-5
    max_position: int = 131072
    tie_embeddings: bool = True
    ssm_norm: str = "grouped"

    def __post_init__(self):
        super().__post_init__()
        if self.family != "granite4h":
            raise ValueError(f"a GraniteMoeHybridConfig is of family 'granite4h', not "
                             f"{self.family!r}")

    @property
    def n_attn(self) -> int:
        return len(self.attn_layer_ids)

    @property
    def n_mamba(self) -> int:
        return self.n_layers - self.n_attn

    def _expert_params(self) -> int:
        """One routed expert: gate and up [2 d_ff, D], down [D, d_ff]."""
        return 3 * self.d_model * self.d_ff

    def param_count(self) -> int:
        """Parameters as published: the tied embedding, every layer's two
        norms, router, experts and shared expert, the mamba and attention
        mixers, the final norm."""
        D, Di, G, N = self.d_model, self.d_inner, self.ssm_groups, self.ssm_state
        H, E = self.ssm_heads, self.n_experts
        conv = Di + 2 * G * N
        mamba = (D * (Di + conv + H) + conv * (4 + int(self.conv_bias)) + 3 * H + Di
                 + Di * D)
        hq, hkv = self.n_heads * self.d_head, self.n_kv_heads * self.d_head
        attn = D * hq + 2 * D * hkv + hq * D
        ffn = 2 * D + D * E + E * self._expert_params() + 3 * D * self.shared_d_ff
        return (self.vocab_size * D + self.n_layers * ffn + self.n_mamba * mamba
                + self.n_attn * attn + D)

    def active_param_count(self) -> int:
        """Parameters a token touches: every expert but its ``top_k`` of
        ``n_experts`` left out, the shared expert and the router kept."""
        idle = self.n_layers * (self.n_experts - self.top_k) * self._expert_params()
        return self.param_count() - idle


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config(ArchConfig):
    """DeepSeek-V3's block as published (``transformers``'
    ``DeepseekV3ForCausalLM``, model type ``deepseek_v3``), without q_lora,
    as Kanana-2-30B-A3B-Instruct runs it.

    ``n_layers`` decoder layers, each latent attention (MLA) then a
    feed-forward block.  MLA: q = x W_q, ``n_heads`` heads of
    ``qk_nope_dim`` + ``qk_rope_dim``; [c, k_pe] = x W_kv_a, c normalised
    by its own RMSNorm (``kv_lora_rank`` wide), k_pe one rope head shared
    by every head; per head k_nope and v = c W_kv_b (``qk_nope_dim`` and
    ``v_head_dim``); RoPE (theta ``rope_theta``) on the ``qk_rope_dim``
    dims of q and k_pe, pairs (2i, 2i + 1) rotated; scores scaled by
    (qk_nope_dim + qk_rope_dim)^-1/2; out = o W_o.  The feed-forward
    block is a SwiGLU of width ``d_ff`` in the first ``first_k_dense``
    layers, and after them a MoE of ``n_experts`` SwiGLU experts of width
    ``moe_d_ff``: sigmoid scores of the f32 router logits, the top
    ``top_k`` of scores + ``e_score_correction_bias``, the gates the
    unbiased scores of those, normalised over the k and times
    ``routed_scaling``; plus ``n_shared_experts`` shared experts as one
    SwiGLU of width ``n_shared_experts`` x ``moe_d_ff``.  Untied
    embeddings.  The family is 'deepseek_v3': the model code dispatches on
    it (``models/deepseek_v3.py``).
    """
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    first_k_dense: int = 1
    moe_d_ff: int = 768
    n_shared_experts: int = 2
    routed_scaling: float = 2.448
    norm_eps: float = 1e-6
    max_position: int = 32768
    tie_embeddings: bool = False

    def __post_init__(self):
        super().__post_init__()
        if self.family != "deepseek_v3":
            raise ValueError(f"a DeepseekV3Config is of family 'deepseek_v3', not "
                             f"{self.family!r}")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def latent_dim(self) -> int:
        """Values a position of a layer's latent cache holds: c and k_pe."""
        return self.kv_lora_rank + self.qk_rope_dim

    @property
    def n_moe(self) -> int:
        return self.n_layers - self.first_k_dense

    @property
    def shared_d_ff(self) -> int:
        return self.n_shared_experts * self.moe_d_ff

    def _attn_params(self) -> int:
        D, H, r = self.d_model, self.n_heads, self.kv_lora_rank
        return (D * H * self.qk_head_dim + D * self.latent_dim + r
                + r * H * (self.qk_nope_dim + self.v_head_dim) + H * self.v_head_dim * D)

    def param_count(self) -> int:
        """Parameters as published: the embedding and the head (untied),
        every layer's two norms and MLA, the dense SwiGLUs, each MoE
        layer's router, bias, experts and shared experts, the final norm."""
        D, E = self.d_model, self.n_experts
        moe = D * E + E + E * 3 * D * self.moe_d_ff + 3 * D * self.shared_d_ff
        return (2 * self.vocab_size * D + self.n_layers * (2 * D + self._attn_params())
                + self.first_k_dense * 3 * D * self.d_ff + self.n_moe * moe + D)

    def active_param_count(self) -> int:
        """Parameters a token touches: every routed expert but its ``top_k``
        left out."""
        idle = self.n_moe * (self.n_experts - self.top_k) * 3 * self.d_model * self.moe_d_ff
        return self.param_count() - idle
