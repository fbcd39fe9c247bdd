"""Faults planted in the program, for the Kanana-2 (MLA) cell's comparison:
each must come out not correct.  The CPU tests plant them at the smoke
size (``nspubench/tests/test_nspubench_mla.py``); on the card this module
runs the cell's generator at its full size and prints, as JSON lines, the
readings of the sound program, of the witness (the reference at the
configuration's own precision) and of the control in the program's place
(the reference computed once a request for the three, each on the
program's routing), then each planted fault's (one batch each), beside
the limits:

    python3 -m nspubench.mla_faults --workload kanana-2-30b-a3b-instruct.longdoc32k \
        --seeds 1,2 [--seconds 30] [--faults all|none|3,7] [--control 1] [--sound 1]

(``--faults 3,7``: the third and the seventh of ``FAULTS`` only; ``--sound
0``: no reading of the sound program, the witness or the control)
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

FAULTS = (
    "RoPE rotates the halves instead of the pairs",
    "scores are scaled by 128^-1/2",
    "the decode's latent row skips kv_a_layernorm",
    "the router's bias is added to the gates",
    "the routed scaling 2.448 is dropped",
    "the shared experts are dropped",
    "the decode's latent row is written one position early",
    "the router chooses without its bias",
)


def plant(fault: str, patch, model=None) -> None:
    """Plant ``fault`` in the program through ``patch(owner, name, value)``
    (``monkeypatch.setattr``'s signature); the routed scaling's fault
    replaces the config of ``model`` (so a captured decode graph reads it
    too) where one is given, else of every model the loader builds."""
    from repro_torch.models import deepseek_v3 as ds
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as T

    if fault == FAULTS[0]:
        patch(ds, "apply_rope_pairs", L.apply_rope_half)
    elif fault == FAULTS[1]:
        patch(ds, "softmax_scale", lambda cfg: L._f32_scalar(cfg.qk_nope_dim ** -0.5))
    elif fault == FAULTS[2]:
        real = ds._latent

        def unnormed(p, u, cfg, rope):
            c, k_pe = real(p, u, cfg, rope)
            if u.shape[1] == 1:  # a decode step: c as kv_a_proj_with_mqa gives it
                c = (u @ p["wkv_a"])[..., : cfg.kv_lora_rank]
            return c, k_pe

        patch(ds, "_latent", unnormed)
    elif fault == FAULTS[3]:
        def biased(x, router, bias, top_k, scaling):
            ct = L._acc(router.dtype)
            return _gates(torch.sigmoid(x.to(ct) @ router.to(ct)) + bias.to(ct), top_k, scaling)

        patch(moe_lib, "route_sigmoid", biased)
    elif fault == FAULTS[4]:
        if model is not None:
            patch(model, "cfg", dataclasses.replace(model.cfg, routed_scaling=1.0))
            return
        real = T.params_from_hf

        def unscaled(state, cfg, device=None):
            return real(state, dataclasses.replace(cfg, routed_scaling=1.0), device)

        patch(T, "params_from_hf", unscaled)
    elif fault == FAULTS[5]:
        patch(ds, "_shared", lambda blk, u: torch.zeros_like(u))
    elif fault == FAULTS[6]:
        real = ds._write_latent

        def early(lat, row, pos):
            real(lat, row, None if pos is None else pos - 1)

        patch(ds, "_write_latent", early)
    elif fault == FAULTS[7]:
        real = moe_lib.route_sigmoid

        def unbiased(x, router, bias, top_k, scaling):
            return real(x, router, torch.zeros_like(bias), top_k, scaling)

        patch(moe_lib, "route_sigmoid", unbiased)
    else:
        raise ValueError(fault)


def _gates(scores: torch.Tensor, top_k: int, scaling: float) -> tuple:
    """The fault's routing: the top k of scores + bias, and their gates
    from the same biased scores."""
    _, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    ids = order[:, :top_k]
    gates = scores.gather(1, ids)
    return gates / (gates.sum(dim=-1, keepdim=True) + 1e-20) * scaling, ids, scores


def probe(cell: dict, seeds, seconds: float, device, faults=True,
          control: bool = True, out=sys.stdout, sound: bool = True) -> list:
    """The readings of the program, the witness and the control on each
    seed (unless ``sound`` is False), and, on the first, of each planted
    fault (``faults``: True, False or the faults to plant; one batch
    each); one JSON line each, returned too."""
    planted = FAULTS if faults is True else tuple(faults or ())
    from nspubench import run

    def read(gen, stand_ins):
        # the program stays on the card beside the reference's f32 blocks:
        # its decode graph's latent cache (7.4 GB at the cell's size) goes,
        # the next window captures it again, and the reference gets the
        # allocator's cached blocks
        gen.model.__dict__.pop("_decode_graph", None)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return gen.readings_of(stand_ins)

    lines = []
    for i, seed in enumerate(seeds):
        gen = run.load_generator(cell["traffic"]["generator"]).Generator(
            cell["config"], cell["traffic"], seed, device, seconds)
        gen.setup()
        gen.window(seconds)
        lim = gen.limits
        kinds = (["program", "witness"] + (["control"] if control else [])) if sound else []
        stand_ins = [None, {"act": torch.bfloat16}, {"acc": torch.bfloat16}][: len(kinds)]
        t = time.perf_counter()
        got = read(gen, stand_ins) if kinds else []
        t = time.perf_counter() - t
        for kind, g in zip(kinds, got):
            lines.append(lm_faults._line(kind, seed, g, lim, t, out,
                                         **({"requests": gen.requests} if kind == "program"
                                            else {})))
        if planted and i == 0:
            gen.k = 1
            for fault in planted:
                patches = lm_faults._Patches()
                gen.model.__dict__.pop("_decode_graph", None)
                plant(fault, patches, gen.model)
                try:
                    gen.window(1e-3)  # one batch
                finally:
                    patches.restore()
                    gen.model.__dict__.pop("_decode_graph", None)
                t = time.perf_counter()
                lines.append(lm_faults._line("fault", seed, read(gen, [None])[0], lim,
                                             time.perf_counter() - t, out, fault=fault,
                                             failed=gen.failed))
        del gen
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--faults", default="all", help="all, none or fault numbers: 3,7")
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--sound", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from nspubench import run

    run.cache_env(ROOT)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = run.find_cell(manifest, args.workload, ROOT)
    print(json.dumps({"card": run.card_line()}), flush=True)
    faults = {"all": True, "none": False}.get(args.faults)
    if faults is None:
        faults = [FAULTS[int(n) - 1] for n in args.faults.split(",")]
    probe(cell, [int(s) for s in args.seeds.split(",")], args.seconds, torch.device("cuda"),
          faults, bool(args.control), sound=bool(args.sound))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
