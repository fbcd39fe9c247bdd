"""The control of a cell: the plain reference computed in bfloat16
(weights and potential), the precision below the configuration's
float32, put in the program's place on the inputs a run of the cell
would compare, and held to the cell's comparison.  It must come out not
correct; its readings are the upper ends the limits were set below.

    python3 -m nspubench.control --workload <cell> --seeds 1,2,3 [--seconds 10]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def readings(cell: dict, seed: int, seconds: float, device) -> dict:
    """{number: (reading, limit)} of the control on one seed."""
    from nspubench import run

    gen = run.load_generator(cell["traffic"]["generator"]).Generator(
        cell["config"], cell["traffic"], seed, device, seconds)
    gen.plan_control(seconds)
    return gen.check(full=False, control=True)["checks"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from nspubench import run

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = run.find_cell(manifest, args.workload, ROOT)
    seconds = args.seconds if args.seconds is not None else manifest["run_seconds"]
    for s in args.seeds.split(","):
        checks = readings(cell, int(s), seconds, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": int(s), "control": {
            k: {"value": v, "limit": lim, "fails": v > lim} for k, (v, lim) in checks.items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
