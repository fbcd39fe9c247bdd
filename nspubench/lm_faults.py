"""Faults planted in the program, for the LM cell's comparison: each must
come out not correct.  The CPU tests plant them at the smoke size
(``nspubench/tests/test_nspubench_lm.py``); on the card this module runs a
cell's generator at its full size and prints, as JSON lines, the readings
of the sound program, of the witness (the reference at the configuration's
own precision) and of the control in the program's place, then each
planted fault's, beside the limits:

    python3 -m nspubench.lm_faults --workload zamba2-7b-instruct.docs4k \
        --seeds 1,2 [--seconds 30] [--faults all|none] [--control 1]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

FAULTS = (
    "a decode step reads a stale conv state",
    "a decode step reads a stale SSM state",
    "the prefill's SSM state is not carried between chunks",
    "a decode step's attention reads a stale row",
    "an application's adapter is dropped",
    "a shared block's output added to the residual",
)


def plant(fault: str, patch, model=None) -> None:
    """Plant ``fault`` in the program through ``patch(owner, name, value)``
    (``monkeypatch.setattr``'s signature); the adapter's fault zeroes the
    weight in ``model`` instead, when one is given (so a captured decode
    graph reads it too), else in every model the loader builds."""
    from repro_torch.models import ssm, transformer, zamba2

    if fault == "a decode step reads a stale conv state":
        real = ssm._one_token

        def stale_conv(params, proj, cfg, cache):
            return real(params, proj, cfg, dict(cache, conv=torch.zeros_like(cache["conv"])))

        patch(ssm, "_one_token", stale_conv)
    elif fault == "a decode step reads a stale SSM state":
        real = ssm._one_token

        def stale_state(params, proj, cfg, cache):
            y, new = real(params, proj, cfg, cache)
            return y, dict(new, S=cache["S"].clone())  # the step's state is not kept

        patch(ssm, "_one_token", stale_state)
    elif fault == "the prefill's SSM state is not carried between chunks":
        real = ssm.ssd_chunked

        def no_carry(x, dt, A, Bm, Cm, chunk, initial_state=None, compute_dtype=torch.float32):
            if initial_state is None or x.shape[1] <= chunk:
                return real(x, dt, A, Bm, Cm, chunk, initial_state, compute_dtype)
            ys = []
            for c0 in range(0, x.shape[1], chunk):
                c = slice(c0, c0 + chunk)
                y, S = real(x[:, c], dt[:, c], A, Bm[:, c], Cm[:, c], chunk, initial_state,
                            compute_dtype)
                ys.append(y)
            return torch.cat(ys, dim=1), S

        patch(ssm, "ssd_chunked", no_carry)
    elif fault == "a decode step's attention reads a stale row":
        real = zamba2._attention

        def stale_row(blk, u, cfg, rope, kv):
            if kv is not None and "pos" in kv:  # K and V written a row early
                kv = dict(kv, pos=kv["pos"] - 1)
            return real(blk, u, cfg, rope, kv)

        patch(zamba2, "_attention", stale_row)
    elif fault == "an application's adapter is dropped":
        if model is not None:
            with torch.no_grad():
                model.apps[0].params()["adapter_b"].zero_()
            return
        real = transformer.params_from_hf

        def dropped(state, cfg, device=None):
            m = real(state, cfg, device)
            with torch.no_grad():
                m.apps[0].params()["adapter_b"].zero_()
            return m

        patch(transformer, "params_from_hf", dropped)
    elif fault == "a shared block's output added to the residual":
        real = zamba2._mamba

        def residual(blk, h, cfg, add, cache, i):
            out = real(blk, h, cfg, None, cache, i)
            return out if add is None else out + add

        patch(zamba2, "_mamba", residual)
    else:
        raise ValueError(fault)


class _Patches:
    def __init__(self):
        self.undo = []

    def __call__(self, owner, name, value):
        self.undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def restore(self):
        for owner, name, value in reversed(self.undo):
            setattr(owner, name, value)
        self.undo.clear()


def _line(kind: str, seed: int, got: dict, limits: dict, seconds: float, out, **kw) -> dict:
    line = {"kind": kind, "seed": seed, "seconds": round(seconds, 1), **kw,
            "readings": {k: {"value": v, "limit": limits.get(k),
                             "over": (v > limits[k]) if k in limits else None}
                         for k, v in got.items()}}
    print(json.dumps(line), file=out, flush=True)
    return line


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
        lines.append(_line("program", seed, gen.readings(), lim, time.perf_counter() - t, out,
                           requests=gen.requests))
        t = time.perf_counter()
        lines.append(_line("witness", seed, gen.readings({"act": torch.bfloat16}), lim,
                           time.perf_counter() - t, out))
        if control:
            t = time.perf_counter()
            lines.append(_line("control", seed, gen.readings({"acc": torch.bfloat16}), lim,
                               time.perf_counter() - t, out))
        if faults and i == 0:
            gen.k = 1
            adapter = gen.model.apps[0].params()["adapter_b"]
            saved = adapter.detach().clone()
            for fault in FAULTS:
                patches = _Patches()
                gen.model.__dict__.pop("_decode_graph", None)
                plant(fault, patches, gen.model)
                try:
                    gen.window(1e-3)  # one batch
                finally:
                    patches.restore()
                    with torch.no_grad():
                        adapter.copy_(saved)
                    gen.model.__dict__.pop("_decode_graph", None)
                t = time.perf_counter()
                lines.append(_line("fault", seed, gen.readings(), lim, time.perf_counter() - t,
                                   out, fault=fault))
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
