"""Elastic resume: continue a run on another device, or another shard
layout, from its latest checkpoint.

Port of the JAX package's ``distributed/elastic.py``.  What makes it work:
  * checkpoints store host arrays and a manifest (``checkpoint.py``), and
    ``Trainer.restore`` places them on the trainer's device, so a run
    written on the CPU resumes on the card and the other way round;
  * the data stream is addressed by (step, shard, num_shards)
    (``data/tokens.py``): re-sharding only re-slices the same global batch.

The JAX package re-places the restored leaves under a new device mesh's
shardings; one card has no mesh and no placement by sharding, so the shard
counts here are checked, as the JAX package checks its mesh's axes, and
the trainer runs on one device.
"""
from __future__ import annotations

from repro_torch.data.tokens import DataConfig
from repro_torch.distributed.train_loop import TrainConfig, Trainer
from repro_torch.models.config import ArchConfig


def resume_elastic(
    arch: ArchConfig,
    data_cfg: DataConfig,
    train_cfg: TrainConfig,
    data_shards: int = 1,
    model_shards: int = 1,
    device=None,
) -> Trainer:
    """A Trainer on ``device`` whose run() restores the latest checkpoint
    and continues the step sequence.

    Requirements checked here rather than discovered mid-run:
      * the global batch must divide over the data shards,
      * the MoE experts must divide over the model shards.
    """
    if data_cfg.global_batch % data_shards:
        raise ValueError(
            f"global_batch {data_cfg.global_batch} does not divide over "
            f"{data_shards} data shards"
        )
    if arch.n_experts and arch.n_experts % model_shards:
        raise ValueError(
            f"{arch.n_experts} experts do not divide over {model_shards} "
            f"model shards"
        )
    return Trainer(arch, data_cfg, train_cfg, device=device)
