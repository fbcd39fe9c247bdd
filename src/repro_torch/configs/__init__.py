"""Model configurations of the port: the paper's TNN column designs
(``tnn_columns``) and the LM architectures, resolved by ``--arch <id>``.

Each arch module exposes ``full()`` (the exact published config) and
``smoke()`` (a reduced CPU-testable config), as in the JAX package, for
all ten of its ids (``ARCH_IDS``).  ``PORT_ONLY`` holds the ids the
JAX package has no twin of (``zamba2-7b-instruct``, Zamba2 as published;
``granite-4.0-h-small``, Granite 4.0-H as published;
``kanana-2-30b-a3b-instruct``, DeepSeek-V3's block as published);
``get_arch`` resolves both, and the tests that walk ``ARCH_IDS`` against
the JAX registry never meet them.  ``SHAPES`` is the dry run's table of input shapes
and ``input_specs`` builds the ``meta`` stand-ins each (arch x shape)
cell runs against (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs import (
    deepseek_coder_33b,
    granite_3_8b,
    granite_4_0_h_small,
    kanana_2_30b_a3b_instruct,
    kimi_k2_1t_a32b,
    mamba2_370m,
    olmoe_1b_7b,
    qwen2_vl_7b,
    qwen3_14b,
    starcoder2_15b,
    whisper_medium,
    zamba2_7b,
    zamba2_7b_instruct,
)
from repro_torch.models.config import ArchConfig

_MODULES = (
    kimi_k2_1t_a32b,
    olmoe_1b_7b,
    qwen3_14b,
    granite_3_8b,
    starcoder2_15b,
    deepseek_coder_33b,
    whisper_medium,
    qwen2_vl_7b,
    zamba2_7b,
    mamba2_370m,
)

REGISTRY = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)
PORT_ONLY = {m.ARCH_ID: m for m in (zamba2_7b_instruct, granite_4_0_h_small,
                                    kanana_2_30b_a3b_instruct)}


def get_arch(arch_id: str, smoke: bool = False) -> ArchConfig:
    mod = REGISTRY.get(arch_id) or PORT_ONLY.get(arch_id)
    if mod is None:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS + tuple(PORT_ONLY)}")
    return mod.smoke() if smoke else mod.full()


# --------------------------------------------------------------------------
# shapes (assigned per-arch input-shape set)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid (their
# attention state is O(1) / sharded-KV); skip for the 8 pure full-attention
# archs.
_LONG_OK_FAMILIES = ("ssm", "hybrid", "zamba2")


def applicable(cfg: ArchConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.family in _LONG_OK_FAMILIES
    return True


def skip_reason(cfg: ArchConfig, shape: str) -> Optional[str]:
    if applicable(cfg, shape):
        return None
    return (
        f"{cfg.name} is pure full-attention; long_500k (seq 524288) requires "
        "sub-quadratic attention (run for ssm/hybrid only)"
    )


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """``meta`` stand-ins for every model input of this cell, in the JAX
    package's dtypes (nothing is allocated).

    train:   {'tokens','labels'} [B, S]  (+ 'frames' for audio,
             + 'positions' [3, B, S] for M-RoPE VLM)
    prefill: {'tokens'} [B, S] (+ 'frames')
    decode:  {'tokens'} [B, 1] (the cache comes from ``init_cache``).
    """
    B, S = shape.global_batch, shape.seq_len

    def empty(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        specs = {"tokens": empty(B, S), "labels": empty(B, S)}
        if cfg.family == "audio":
            specs["frames"] = empty(B, cfg.enc_seq, cfg.d_model, dtype=torch.bfloat16)
        if cfg.mrope:
            specs["positions"] = empty(3, B, S)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": empty(B, S)}
        if cfg.family == "audio":
            specs["frames"] = empty(B, cfg.enc_seq, cfg.d_model, dtype=torch.bfloat16)
        return specs
    if shape.kind == "decode":
        return {"tokens": empty(B, 1)}
    raise ValueError(shape.kind)
