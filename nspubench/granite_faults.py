"""Faults planted in the program, for the Granite 4.0-H cell's comparison:
each must come out not correct, or ``PERF.md`` says why it cannot.  The
CPU tests plant them at the smoke size
(``nspubench/tests/test_nspubench_granite.py``); on the card this module
runs the cell's generator at its full size and prints, as JSON lines, the
readings of the sound program, of the witness (the reference at the
configuration's own precision) and of the control in the program's place,
then each planted fault's (one batch each), beside the limits:

    python3 -m nspubench.granite_faults --workload granite-4.0-h-small.rag2k \
        --seeds 1,2 [--seconds 30] [--faults all|none] [--control 1]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import torch

from nspubench import lm_faults

ROOT = pathlib.Path(__file__).resolve().parent.parent

NOT_CARRIED = "the prefill's SSM state is not carried between chunks"
FAULTS = (
    "the MoE drops assignments past a capacity of cf 2.0",
    "the shared expert is dropped",
    "the residual multiplier is 1",
    "RoPE is applied to q and k",
    "scores are scaled by head_dim^-1/2",
    NOT_CARRIED,
)


def capped_moe(x, params, top_k, static=False, cf=2.0):
    """``moe.moe_dropless`` with the capacity path's drops: each expert
    keeps the first cap_e = max(1, round(T k / E cf)) of its assignments
    in flat (token, slot) order, as the JAX package's capacity path does;
    every shape fixed, so a decode graph captures it."""
    from repro_torch.models import moe as moe_lib

    E = params["w_in"].shape[0]
    cap = int(max(1, round(x.shape[0] * top_k / E * cf)))
    probs, ids, _ = moe_lib.route(x, params["router"], top_k)
    y = moe_lib.experts_in_slots(x, params, probs, ids, cap)
    return y, ids, None if static else moe_lib.expert_loads(ids, E).tolist()


def plant(fault: str, patch, model=None) -> None:
    """Plant ``fault`` in the program through ``patch(owner, name, value)``
    (``monkeypatch.setattr``'s signature); the residual multiplier's fault
    replaces the config of ``model`` (so a captured decode graph reads it
    too) where one is given, else of every model the loader builds."""
    from repro_torch.models import granite4h
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as T

    if fault == FAULTS[0]:
        patch(moe_lib, "moe_dropless", capped_moe)
    elif fault == FAULTS[1]:
        patch(granite4h, "_shared", lambda blk, u: torch.zeros_like(u))
    elif fault == FAULTS[2]:
        if model is not None:
            patch(model, "cfg", dataclasses.replace(model.cfg, residual_multiplier=1.0))
            return
        real = T.params_from_hf

        def unscaled(state, cfg, device=None):
            return real(state, dataclasses.replace(cfg, residual_multiplier=1.0), device)

        patch(T, "params_from_hf", unscaled)
    elif fault in (FAULTS[3], FAULTS[4]):
        real = L.cached_attend
        rope = fault == FAULTS[3]

        def wrong(q, k, v, cfg, scale, kv):
            if rope:
                B, S = q.shape[:2]
                at = kv["pos"].expand(B, 1) if kv is not None and "pos" in kv else \
                    torch.arange(S, device=q.device).expand(B, S)
                tables = L.rope_half_tables(at, cfg.d_head, cfg.rope_theta, q.dtype)
                q, k = L.apply_rope_half(q, tables), L.apply_rope_half(k, tables)
            else:
                scale = cfg.d_head ** -0.5
            return real(q, k, v, cfg, scale, kv)

        patch(L, "cached_attend", wrong)
    elif fault == NOT_CARRIED:
        lm_faults.plant(fault, patch)
    else:
        raise ValueError(fault)


def probe(cell: dict, seeds, seconds: float, device, faults: bool = True,
          control: bool = True, out=sys.stdout) -> list:
    """The readings of the program, the witness and the control on each
    seed, and, on the first, of each planted fault (one batch each); one
    JSON line each, returned too."""
    from nspubench import run

    lines = []
    for i, seed in enumerate(seeds):
        gen = run.load_generator(cell["traffic"]["generator"]).Generator(
            cell["config"], cell["traffic"], seed, device, seconds)
        gen.setup()
        gen.window(seconds)
        lim = gen.limits
        t = time.perf_counter()
        lines.append(lm_faults._line("program", seed, gen.readings(), lim,
                                     time.perf_counter() - t, out, requests=gen.requests))
        t = time.perf_counter()
        lines.append(lm_faults._line("witness", seed, gen.readings({"act": torch.bfloat16}),
                                     lim, time.perf_counter() - t, out))
        if control:
            t = time.perf_counter()
            lines.append(lm_faults._line("control", seed, gen.readings({"acc": torch.bfloat16}),
                                         lim, time.perf_counter() - t, out))
        if faults and i == 0:
            gen.k = 1
            for fault in FAULTS:
                patches = lm_faults._Patches()
                gen.model.__dict__.pop("_decode_graph", None)
                plant(fault, patches, gen.model)
                try:
                    gen.window(1e-3)  # one batch
                finally:
                    patches.restore()
                    gen.model.__dict__.pop("_decode_graph", None)
                t = time.perf_counter()
                lines.append(lm_faults._line("fault", seed, gen.readings(), lim,
                                             time.perf_counter() - t, out, fault=fault))
        del gen
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--faults", choices=("all", "none"), default="all")
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from nspubench import run

    run.cache_env(ROOT)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = run.find_cell(manifest, args.workload, ROOT)
    print(json.dumps({"card": run.card_line()}), flush=True)
    probe(cell, [int(s) for s in args.seeds.split(",")], args.seconds, torch.device("cuda"),
          args.faults == "all", bool(args.control))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
