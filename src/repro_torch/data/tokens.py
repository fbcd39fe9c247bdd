"""Deterministic synthetic token stream for LM training.

Port of the JAX package's ``data/tokens.py``, with the port's own random
stream: each step's global batch is drawn from a ``torch.Generator`` seeded
by a counter key of (seed, step), on the CPU, and then moved to the
caller's device, so every device sees the same tokens.  Resuming at step k
regenerates the identical batch (the restart tests rely on it), and
re-sharding only re-slices the same global batch.  The structure is the
JAX package's: uniform tokens over [B, S + 1], every position with
``pos % 4 == 3`` replaced by the token before it (``roll`` by one), inputs
``[:, :-1]`` and labels ``[:, 1:]``, both int32.  The streams of the two
packages differ; parity tests inject the JAX package's batches.
"""
from __future__ import annotations

import dataclasses

import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0


def _step_key(seed: int, step: int) -> int:
    """SplitMix64 of (seed, step): one generator seed per step."""
    x = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class TokenSource:
    """Stateless, index-addressable synthetic corpus; batches on ``device``."""

    def __init__(self, cfg: DataConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)

    def global_batch_at(self, step: int) -> dict:
        """Full global batch for a step: {'tokens', 'labels'} [B, S] int32."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(_step_key(cfg.seed, step))
        toks = torch.randint(0, cfg.vocab_size, (cfg.global_batch, cfg.seq_len + 1),
                             generator=gen, dtype=torch.int64).to(torch.int32)
        # learnable structure: every fourth position repeats the token before it
        pos = torch.arange(cfg.seq_len + 1)
        toks = torch.where(pos[None, :] % 4 == 3, torch.roll(toks, 1, dims=1), toks)
        toks = toks.to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def shard_at(self, step: int, shard: int, num_shards: int) -> dict:
        """This shard's slice of the global batch (restart/elastic safe)."""
        if self.cfg.global_batch % num_shards:
            raise ValueError(
                f"global_batch {self.cfg.global_batch} not divisible by "
                f"{num_shards} shards"
            )
        b = self.cfg.global_batch // num_shards
        full = self.global_batch_at(step)
        sl = slice(shard * b, (shard + 1) * b)
        return {k: v[sl] for k, v in full.items()}
