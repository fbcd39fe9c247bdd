"""Serving launcher: prefill a batch of prompts, then decode greedily with
the KV and state caches.

    python -m repro_torch.launch.serve --arch granite-3-8b --batch 4 \\
        --prompt-len 2048 --tokens 16
    python -m repro_torch.launch.serve --arch mamba2-370m --smoke --device cpu

Port of the JAX package's ``launch/serve.py``, every arch id: the same
flags and ``[serve]`` lines, plus ``--device`` (``cuda`` unless asked
otherwise; without a card it raises and never carries on on the CPU).
Weights are random, drawn on the device from a seeded ``torch.Generator``,
and so are the prompts unless the caller passes its own (``serve(...,
prompts=, model=)``: a benchmark's token ids and loaded weights); the audio
family's frame embeddings are zeros in the model's dtype, as in the JAX
package.  On the card every attention of a prefill (and whisper's
cross-attention of each decode step, and the published models' decode
attention over their caches) runs the flash kernel; each decode step is
one token per request.  The published models' decode step
(``T.decode_step`` at a device position; Zamba2 and Granite 4.0-H,
``T.published``) runs on the card as one CUDA graph (``models/zamba2.py``'s
``DecodeGraph``) over a cache the model keeps with it, captured at the
first batch of a shape and replaced by a batch of another (span
``lm.decode_graph``: the capture, or the next batch's reset of the cache;
timed in neither phase).

Traced (``repro_torch.obs`` on): spans ``lm.prefill`` (batch, prompt
length; it ends at the first token's copy to the host) and
``lm.decode_step`` (step; it ends at the step's token copy), counters
``lm.tokens_prefilled`` and ``lm.tokens_decoded``.  Under the decode graph
the spans inside a step (``lm.shared_block``, ``lm.moe``) are not
recorded; a model whose module has ``observe_decode`` (Granite 4.0-H's
MoE counters) reads what the step left in its cache after the step's
token copy.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
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
    # [len(keep), tokens - 1, V_padded]: each decode step's logits of the
    # rows ``serve`` was asked to keep (None where none were)
    step_logits: Optional[torch.Tensor] = None
    # those rows of every tensor of the cache after the last step (each
    # cache tensor holds the batch on its axis 1), in ``keep``'s order
    kept_cache: Optional[dict] = None
    # what the model tapped of those rows, by name, each [len(keep),
    # layers, ...] (Granite 4.0-H: 'moe', each MoE block's output on the
    # prompt [len(keep), L, S, D], and 'moe_decode', at each decode step
    # [len(keep), L, tokens - 1, D]); None where nothing was
    kept_taps: Optional[dict] = None

    @property
    def decode_s_per_token(self) -> float:
        return self.decode_s / max(self.generations.shape[1] - 1, 1)


def serve(
    cfg: ArchConfig,
    *,
    batch: int = 0,
    prompt_len: int = 0,
    tokens: int,
    device=None,
    seed: int = 0,
    model: Optional[T.Transformer] = None,
    frames: Optional[torch.Tensor] = None,
    prompts: Optional[torch.Tensor] = None,
    keep: Optional[Sequence[int]] = None,
) -> ServeResult:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then ``tokens -
    1`` greedy decode steps, under ``torch.inference_mode()``.  ``prompts``
    [batch, prompt_len] (token ids on the device) default to random ones
    from ``seed``; ``model`` defaults to random weights from ``seed`` on
    ``device``; the audio family's ``frames`` [batch, enc_seq, d_model]
    default to zeros.  ``keep``: rows whose every decode step's logits and
    final cache are kept (``step_logits``, ``kept_cache``), and what the
    model taps of them in the prefill and the decode steps
    (``kept_taps``)."""
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        if model is None:
            model = T.init_params(cfg, generator=gen, device=dev)
        if prompts is None:
            prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                    generator=gen, device=dev)
        batch, prompt_len = prompts.shape
        if cfg.family == "audio" and frames is None:
            frames = torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                                 dtype=model.embed.dtype, device=dev)
        rows = None if keep is None else torch.as_tensor(list(keep), device=dev)
        kept = []
        max_len = prompt_len + tokens + 1
        cache = graph = None
        lib = T.published(cfg)
        observe = getattr(lib, "observe_decode", None)
        step_taps = getattr(lib, "decode_taps", None) if rows is not None else None
        if lib is not None and dev.type == "cuda":
            # a published model's decode step runs as one CUDA graph over the
            # cache the model keeps with it (captured at the first batch of
            # this shape)
            with obs.span("lm.decode_graph"):
                graph = lib.decode_graph(model, batch, max_len)
                cache = graph.cache
        taps = {}
        if rows is not None:
            model.__dict__["_taps"] = (rows, taps)
        t0 = time.perf_counter()
        try:
            with obs.span("lm.prefill", (batch, prompt_len) if obs.ON else ()):
                cache, logits = T.prefill(model, prompts, max_len=max_len, frames=frames,
                                          cache=cache)
                tok = torch.argmax(logits[:, -1:, : cfg.vocab_size], dim=-1)
                out = [tok.cpu().numpy()]
        finally:
            model.__dict__.pop("_taps", None)
        prefill_taps = set(taps)
        obs.count("lm.tokens_prefilled", batch * prompt_len)
        t_prefill = time.perf_counter() - t0
        prefill_logits = logits
        t0 = time.perf_counter()
        for step in range(tokens - 1):
            with obs.span("lm.decode_step", (step,) if obs.ON else ()):
                if graph is not None:
                    logits = graph.step(tok, prompt_len + step)
                else:
                    cache, logits = T.decode_step(model, cache, tok)
                tok = torch.argmax(logits[:, -1:, : cfg.vocab_size], dim=-1)
                if rows is not None:
                    kept.append(logits[rows, -1])
                if step_taps is not None:
                    for k, t in step_taps(cache).items():
                        taps.setdefault(k, []).append(t.index_select(1, rows))
                out.append(tok.cpu().numpy())
                if observe is not None and obs.ON:
                    observe(model, cache)
            obs.count("lm.tokens_decoded", batch)
        t_decode = time.perf_counter() - t0
        kept_cache = None if rows is None else {
            k: v.index_select(1, rows) for k, v in cache.items() if torch.is_tensor(v)}
    step_logits = torch.stack(kept, dim=1) if kept else None
    # [len(keep), layers, ...]: the prefill's taps [layers][len(keep), ...];
    # the decode steps' [steps][layers, len(keep), ...], each row's steps
    # in order ([len(keep), layers, steps, ...])
    kept_taps = {k: torch.stack(v, dim=1) if k in prefill_taps else
                 torch.stack(v, dim=2).transpose(0, 1) for k, v in taps.items()} or None
    return ServeResult(cfg, str(dev), t_prefill, t_decode, np.concatenate(out, axis=1),
                       prefill_logits, logits, step_logits, kept_cache, kept_taps)


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
