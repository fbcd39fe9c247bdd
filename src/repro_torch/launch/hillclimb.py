"""§Perf hillclimb harness: re-measure one dry-run cell under a config
override and report the three roofline terms for before/after logging.

    python -m repro_torch.launch.hillclimb --arch granite-3-8b --shape train_4k \\
        --set kv_chunk=2048 --tag chunk2k

Writes results/perf/<arch>__<shape>__<tag>.json and prints the terms.
Overrides are dataclasses.replace fields on the arch's full() config.
The port's counterpart of the JAX package's ``launch/hillclimb.py``:
the cell is the port dry run's main result (``dryrun._compile_and_analyze``,
whose counts are already whole: there are no cost variants to
extrapolate), analysed by ``roofline/analysis.py``.
"""
import argparse
import dataclasses
import json
import os
import sys


def _coerce(cfg, key: str, val: str):
    cur = getattr(cfg, key)
    if isinstance(cur, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(cur, int):
        return int(val)
    if isinstance(cur, float):
        return float(val)
    return val


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    ap.add_argument("--tag", required=True)
    args = ap.parse_args(argv)

    import repro_torch.configs as C
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline import analysis

    cfg = C.get_arch(args.arch)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        if k not in {f.name for f in dataclasses.fields(cfg)}:
            ap.error(f"{k!r} is not a field of {type(cfg).__name__}")
        overrides[k] = _coerce(cfg, k, v)
    cfg = dataclasses.replace(cfg, **overrides)

    shape = C.SHAPES[args.shape]
    dryrun.init_fake_world(dryrun.world_size(args.mesh))
    mesh = make_production_mesh(multi_pod=(args.mesh == "multi"))
    main_res = dryrun._compile_and_analyze(cfg, shape, mesh)

    cell = {
        "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
        "status": "ok", "n_chips": dryrun.world_size(args.mesh),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "tag": args.tag, "overrides": overrides,
        **main_res,
    }
    row = analysis.analyze_cell(cell)
    cell["roofline"] = {
        "compute_s": row.compute_s, "memory_s": row.memory_s,
        "collective_s": row.collective_s, "dominant": row.dominant,
        "useful_ratio": row.useful_ratio,
        "roofline_fraction": row.roofline_fraction,
        "peak_mem_gb": row.peak_mem_gb,
    }
    os.makedirs("results/perf", exist_ok=True)
    path = f"results/perf/{args.arch}__{args.shape}__{args.tag}.json"
    with open(path, "w") as f:
        json.dump(cell, f, indent=2)
    print(f"[hillclimb] {args.tag}: compute={row.compute_s:.4f}s "
          f"memory={row.memory_s:.4f}s collective={row.collective_s:.4f}s "
          f"dominant={row.dominant} frac={row.roofline_fraction:.4f} "
          f"peak={row.peak_mem_gb:.1f}GB -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
