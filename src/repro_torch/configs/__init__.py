"""Model configurations of the port: the paper's TNN column designs
(``tnn_columns``) and the LM architectures, resolved by ``--arch <id>``.

Each arch module exposes ``full()`` (the exact published config) and
``smoke()`` (a reduced CPU-testable config).  Only the dense family is
ported so far; the JAX package's other ids raise a ``KeyError`` that says
so.  The dry-run's shape table and input specs are not ported.
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_coder_33b,
    granite_3_8b,
    qwen3_14b,
    starcoder2_15b,
)
from repro_torch.models.config import ArchConfig

_MODULES = (
    qwen3_14b,
    granite_3_8b,
    starcoder2_15b,
    deepseek_coder_33b,
)

REGISTRY = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)

# ids the JAX package knows whose families (MoE, audio, VLM, hybrid, SSM)
# the port does not run yet (ROADMAP, queue 1)
NOT_PORTED = (
    "kimi-k2-1t-a32b",
    "olmoe-1b-7b",
    "whisper-medium",
    "qwen2-vl-7b",
    "zamba2-7b",
    "mamba2-370m",
)


def get_arch(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id in NOT_PORTED:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet (only the dense family "
            f"is); ported: {ARCH_IDS}"
        )
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = REGISTRY[arch_id]
    return mod.smoke() if smoke else mod.full()
