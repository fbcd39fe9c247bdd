"""Model configurations of the port: the paper's TNN column designs
(``tnn_columns``) and the LM architectures, resolved by ``--arch <id>``.

Each arch module exposes ``full()`` (the exact published config) and
``smoke()`` (a reduced CPU-testable config), as in the JAX package, for
all ten of its ids.  The dry-run's shape table and input specs are not
ported.
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_coder_33b,
    granite_3_8b,
    kimi_k2_1t_a32b,
    mamba2_370m,
    olmoe_1b_7b,
    qwen2_vl_7b,
    qwen3_14b,
    starcoder2_15b,
    whisper_medium,
    zamba2_7b,
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


def get_arch(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = REGISTRY[arch_id]
    return mod.smoke() if smoke else mod.full()
