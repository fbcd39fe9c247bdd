"""The benchmark of the PyTorch/CUDA port of TNNGen, one cell a run.

    python3 -m nspubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration file and its
traffic file (``nspubench/traffic/<traffic>.json``, whose ``generator``
names the general generator in ``nspubench/generators/``), sets it up from
the seed, warms its own shapes, measures for ``--seconds`` and compares
what the window produced with the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics, each read by
``nspubench/metrics/<name>.py``), ``device`` and, traced, ``breakdown``;
``checks`` comes last, each compared number beside its limit, and the
same lines end standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = pathlib.Path(__file__).resolve().parent


def find_cell(manifest: dict, name: str, root: pathlib.Path) -> dict:
    """The cell ``name`` of a manifest with its configuration and traffic
    loaded from their files, and the names of its metrics."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"nspubench: no workload {name!r} (have {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "nspubench" / "traffic" / f"{cell['traffic']}.json")
                         .read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    return dict(cell=cell, config=config, traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"] if mine(m)],
                per_layer=[m for m in manifest["per_layer"] if mine(m)])


def load_generator(kind: str):
    return importlib.import_module(f"nspubench.generators.{kind}")


def load_reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        f"nspubench.metrics.{metric}", PACKAGE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What a per-layer metric reads: spans, the device trace, the
    generator's work counts, the reference's operation counts, the peaks."""

    def __init__(self, spans, trace, work, counts, peaks):
        self.spans, self.trace, self.work, self.counts, self.peaks = (
            spans, trace, work, counts, peaks)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def cache_env(root: pathlib.Path) -> None:
    """Kernel caches at fixed paths inside the checkout.  The port builds
    its CUDA libraries into ``build/repro_torch_kernels/`` there itself."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def run(workload: str, seed: int, seconds: float, trace: bool, *, root=ROOT,
        device="cuda", t_start: float = T_START, out=sys.stdout, loaded_before=()) -> dict:
    """One run of one cell; prints and returns the result line's object.
    ``loaded_before``: forbidden modules the calling process already held
    (a test's), which the import guard then leaves aside."""
    import torch

    from nspubench import guard
    from nspubench import roofline
    from nspubench.trace import Spans, reduce_trace

    root = pathlib.Path(root)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cell = find_cell(manifest, workload, root)
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    gen = load_generator(cell["traffic"]["generator"]).Generator(
        cell["config"], cell["traffic"], seed, device, seconds)

    gen.setup()
    sync()
    guard.check("after set-up", loaded_before)
    setup_s = time.perf_counter() - t_start

    spans = prof = None
    if trace:
        spans = Spans(sync)
        restore = spans.install()
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
    epoch_minus_perf = time.time_ns() - time.perf_counter_ns()
    t0 = time.perf_counter()
    gen.window(seconds)
    sync()
    t1 = time.perf_counter()
    if trace:
        if prof is not None:
            prof.__exit__(None, None, None)
        restore()
    summary = gen.summary()
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if on_card else 0}
    dtrace = None
    if trace and prof is not None:
        dtrace = reduce_trace(prof, t0, t1, epoch_minus_perf, spans)
        dev["busy_s"] = dtrace.busy_s
        dev["window_s"] = dtrace.window_s
        prof = None
    gen.release()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    result = gen.check(full=trace)
    t_ref = time.perf_counter() - t_ref
    checks = result["checks"]
    correct = all(v <= lim for v, lim in checks.values())

    units = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    metrics = {}
    if not trace:
        values = dict(summary["metrics"], setup_s=setup_s)
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    else:
        ctx = Context(spans, dtrace, summary["work"], result["counts"],
                      roofline.peaks(kind))
        for m in cell["per_layer"]:
            v = load_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    line = {"correct": correct, "attempted": summary["attempted"],
            "failed": summary["failed"], "metrics": metrics, "device": dev}
    if dtrace is not None:
        line["breakdown"] = dtrace.breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    guard.check("at exit", loaded_before)
    print(f"nspubench: {workload} seed {seed} on {kind} ({card_line() if on_card else 'cpu'}); "
          f"window {t1 - t0!r} s, reference {t_ref!r} s", file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=out, flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    cache_env(ROOT)
    import torch

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"nspubench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run(args.workload, args.seed, args.seconds, bool(args.trace))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    raise SystemExit(main())
