"""Training launcher.

    python -m repro_torch.launch.train --arch granite-3-8b --smoke --steps 20 --device cpu
    python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke --microbatches 2

Port of the JAX package's ``launch/train.py``: the same flags and
``[train]`` line, except ``--mesh`` (one card has no device mesh), plus
``--device`` (``cuda`` unless asked otherwise; without a card it raises
and never carries on on the CPU).  It drives the ``Trainer``:
microbatching, checkpointing, straggler monitoring, and resume from the
latest checkpoint in ``--checkpoint-dir``.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import get_arch
from repro_torch.data.tokens import DataConfig
from repro_torch.distributed.train_loop import TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to train on the CPU"
        )
    arch = get_arch(args.arch, smoke=args.smoke)
    data_cfg = DataConfig(
        vocab_size=arch.vocab_size,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
    )
    train_cfg = TrainConfig(
        steps=args.steps,
        microbatches=args.microbatches,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        peak_lr=args.lr,
        compress_grads=args.compress_grads,
    )
    trainer = Trainer(arch, data_cfg, train_cfg, device=args.device)
    out = trainer.run()
    losses = out["losses"]
    print(f"[train] {args.arch}: {len(losses)} steps, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"median step {trainer.monitor.median_s*1e3:.1f} ms, "
          f"stragglers {len(trainer.monitor.events)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
