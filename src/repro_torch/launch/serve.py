"""Serving launcher: prefill a batch of prompts, then decode greedily with
the KV caches.

    python -m repro_torch.launch.serve --arch granite-3-8b --batch 4 \\
        --prompt-len 2048 --tokens 16
    python -m repro_torch.launch.serve --arch granite-3-8b --smoke --device cpu

Port of the JAX package's ``launch/serve.py``, dense family: the same
flags and ``[serve]`` lines, plus ``--device`` (``cuda`` unless asked
otherwise; without a card it raises and never carries on on the CPU).
Weights are random, drawn on the device from a seeded ``torch.Generator``,
and so are the prompts.  Prefill runs the flash kernel once per layer on
the card; each decode step is one token per request.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.backend import default_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class ServeResult:
    """What one serving run produced and how long it took (host clock,
    each phase ended by a copy of its tokens to the host)."""

    cfg: ArchConfig
    device: str
    prefill_s: float
    decode_s: float
    generations: np.ndarray  # [B, tokens] greedy tokens
    prefill_logits: torch.Tensor  # [B, S, V_padded] at every prompt position
    last_logits: torch.Tensor  # [B, 1, V_padded] of the last step

    @property
    def decode_s_per_token(self) -> float:
        return self.decode_s / max(self.generations.shape[1] - 1, 1)


def serve(
    cfg: ArchConfig,
    *,
    batch: int,
    prompt_len: int,
    tokens: int,
    device=None,
    seed: int = 0,
    model: Optional[T.Transformer] = None,
) -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    ``tokens - 1`` greedy decode steps, under ``torch.inference_mode()``.
    ``model`` defaults to random weights from ``seed`` on ``device``."""
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        if model is None:
            model = T.init_params(cfg, generator=gen, device=dev)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=gen, device=dev)
        max_len = prompt_len + tokens + 1
        t0 = time.perf_counter()
        cache, logits = T.prefill(model, prompts, max_len=max_len)
        tok = torch.argmax(logits[:, -1:, : cfg.vocab_size], dim=-1)
        out = [tok.cpu().numpy()]
        t_prefill = time.perf_counter() - t0
        prefill_logits = logits
        t0 = time.perf_counter()
        for _ in range(tokens - 1):
            cache, logits = T.decode_step(model, cache, tok)
            tok = torch.argmax(logits[:, -1:, : cfg.vocab_size], dim=-1)
            out.append(tok.cpu().numpy())
        t_decode = time.perf_counter() - t0
    return ServeResult(cfg, str(dev), t_prefill, t_decode,
                       np.concatenate(out, axis=1), prefill_logits, logits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run the plain "
            "PyTorch versions on the CPU"
        )
    cfg = get_arch(args.arch, smoke=args.smoke)
    B, S = args.batch, args.prompt_len
    r = serve(cfg, batch=B, prompt_len=S, tokens=args.tokens, device=args.device)
    print(f"[serve] {cfg.name}: prefill[{B}x{S}] {r.prefill_s*1e3:.1f} ms, "
          f"{args.tokens} tokens in {r.decode_s*1e3:.1f} ms "
          f"({r.decode_s_per_token*1e3:.1f} ms/tok)")
    print(f"[serve] sample generations: {r.generations[:2, :8].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
