"""The knee of a serving cell: its traffic offered at each of a list of
fixed rates, one service set up afresh for each, to find the highest
rate at which the generator's lateness does not grow across the window
and nothing fails.  The rate found is written into the traffic file by
hand; runs of the benchmark never search for one.

    python3 -m nspubench.knee --workload table2-grid.serve --rates 6000,8000 --seconds 10 --seed 1

One JSON line a rate: the generator's lateness (p95 over the first and
the last quarter of the requests, and the largest), request latency p50
and p95, completed requests/s, failures.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from nspubench import run
    from nspubench.generators import quantile

    run.cache_env(ROOT)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = run.find_cell(manifest, args.workload, ROOT)
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(cell["traffic"], rate_per_s=rate)
        gen = run.load_generator(traffic["generator"]).Generator(
            cell["config"], traffic, args.seed, torch.device("cuda"), args.seconds)
        gen.setup()
        gen.window(args.seconds)
        s = gen.summary()
        late = s["work"]["lateness_s"]
        q = max(1, len(late) // 4)
        print(json.dumps({
            "rate_per_s": rate, "requests": s["attempted"], "failed": s["failed"],
            "late_p95_ms_first_quarter": 1e3 * quantile(late[:q], 0.95),
            "late_p95_ms_last_quarter": 1e3 * quantile(late[-q:], 0.95),
            "late_max_ms": 1e3 * max(late),
            "p50_ms": s["metrics"]["serve_p50_ms"], "p95_ms": s["metrics"]["serve_p95_ms"],
            "served_per_s": s["metrics"]["served_per_s"]}), flush=True)
        gen.release()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
