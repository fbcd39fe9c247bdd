"""The program's tracer (``repro_torch.obs``) read in the benchmark's cells.

A traced window here is what ``nspubench.run`` makes in a ``--trace 1``
run (the harness's spans, the torch profiler over the card), with the
port's tracer on for the window alone: ``obs.reset()`` and
``obs.enable()`` before it, ``obs.disable()`` and ``obs.snapshot()`` after.

    python tools/obs_probe.py trace --cell <cell> --seed n --seconds s
        one traced window: the nine per-layer readings the tracer feeds,
        the device's idle time summed by the innermost program span open
        on the host, each kernel's builds and binds inside the window,
        the harness's own breakdown, and the cell's correctness check.
    python tools/obs_probe.py cost --cell <cell> --seed n --seconds s
        windows in one process with the tracer off and on in turns (off
        on on off off on): each window's end-to-end metrics, the medians
        and the change on against off.

Add ``--tiny`` to run the benchmark tests' tiny cells on the CPU, and
``--out file`` to append the result line to a file.  Runs from the root
of the checkout; imports torch, the port and ``nspubench``, never JAX.

How the readings are joined:

* idle gaps: the profiler's device intervals inside the window, merged;
  a host reading ``t`` (``time.perf_counter()``, the clock of the
  program's spans) is ``t * 1e9 + epoch_minus_perf`` on the profiler's
  clock, ``epoch_minus_perf = time.time_ns() - time.perf_counter_ns()``
  taken as the window opens (the conversion ``nspubench.trace.
  reduce_trace`` uses).  Each gap goes, whole, to the deepest program
  span open on the host at its midpoint;
* serving: each ``submit`` handle's ``id`` is kept in arrival order, so
  the program's request records ``(rid, t_admitted, t_dispatched,
  t_done)`` join the generator's completion times (its ``done_at``,
  relative to its first ``perf_counter`` reading of the window).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from nspubench import run as R  # noqa: E402

R.cache_env(ROOT)

import torch  # noqa: E402

from nspubench.generators import quantile  # noqa: E402
from nspubench.trace import Spans, reduce_trace, _ns  # noqa: E402
from repro_torch import obs  # noqa: E402

ENTRY = {"dse.explore", "sweep.run", "sweep.bucket", "single.column",
         "serve.flush", "serve.batch", "serve.refit"}
TINY = {"tiny-dse.explore": "wordsynonyms-dse.explore",
        "tiny-grid.fit": "table2-grid.fit", "tiny-grid.serve": "table2-grid.serve"}


def make_gen(cell, seed, seconds, device, tiny):
    if tiny:
        from nspubench.tests.conftest import TINY_CELLS, TINY_CONFIGS, TINY_TRAFFIC
        cfg, tr, _ = TINY_CELLS[cell]
        config, traffic = TINY_CONFIGS[cfg], TINY_TRAFFIC[tr]
    else:
        manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
        c = R.find_cell(manifest, cell, ROOT)
        config, traffic = c["config"], c["traffic"]
    kind = traffic["generator"]
    return kind, R.load_generator(kind).Generator(config, traffic, seed, device, seconds)


def device_gaps(prof, t0, t1, epm):
    """Idle gaps [(a, b)] in ns on the profiler's clock (the merge of
    ``reduce_trace``)."""
    lo, hi = int(t0 * 1e9) + epm, int(t1 * 1e9) + epm
    cuda = torch.autograd.DeviceType.CUDA
    iv = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        s, d = _ns(e, "start"), _ns(e, "duration")
        a, b = max(s, lo), min(s + d, hi)
        if b > a:
            iv.append((a, b))
    iv.sort()
    gaps, cur = [], None
    for a, b in iv:
        if cur is None:
            if a > lo:
                gaps.append((lo, a))
            cur = [a, b]
        elif a <= cur[1]:
            cur[1] = max(cur[1], b)
        else:
            gaps.append((cur[1], a))
            cur = [a, b]
    if cur is None:
        gaps.append((lo, hi))
    elif cur[1] < hi:
        gaps.append((cur[1], hi))
    return gaps


def innermost(spans, times):
    """Name of the deepest program span open at each host time."""
    items = sorted((s for s in spans if s[2] is not None), key=lambda s: s[1])
    order = sorted(range(len(times)), key=lambda k: times[k])
    out = [None] * len(times)
    stack, i = [], 0
    for k in order:
        t = times[k]
        while i < len(items) and items[i][1] <= t:
            while stack and stack[-1][2] < items[i][1]:
                stack.pop()
            stack.append(items[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[k] = stack[-1][0] if stack else None
    return out


def dur(spans, name):
    return [s[2] - s[1] for s in spans if s[0] == name]


def readings(kind, snap, work, gen_t0=None, rids=None, gen=None):
    sp, c = snap["spans"], snap["counters"]
    out = {}
    if kind == "serve":
        served = [r for r in snap["requests"] if r[4] == "served"]
        out["serve.queue_wait_ms_p95.lat"] = 1e3 * quantile([r[2] - r[1] for r in served], .95)
        out["serve.exec_ms_p95.lat"] = 1e3 * quantile([r[3] - r[2] for r in served], .95)
        done = {r[0]: r[3] for r in served}
        held = [gen_t0 + gen.done_at[i] - done[rid] for i, rid in enumerate(rids) if rid in done]
        out["serve.held_ms_p95.lat"] = 1e3 * quantile(held, .95)
        out["serve.admit_us_per_request.lat"] = 1e6 * sum(dur(sp, "serve.admit")) / work["requests"]
        out["serve.lanes_useful_pct.lat"] = 100 * c["serve.batch_live"] / c["serve.lanes_fired"]
        out["serve.batch_fill_pct.lat"] = 100 * c["serve.batch_live"] / c["serve.batch_slots"]
        # context beside the six readings
        out["_queue_wait_ms_p50"] = 1e3 * quantile([r[2] - r[1] for r in served], .5)
        out["_exec_ms_p50"] = 1e3 * quantile([r[3] - r[2] for r in served], .5)
        out["_held_ms_p50"] = 1e3 * quantile(held, .5)
        out["_held_ms_max"] = 1e3 * max(held)
        out["_requests_served"] = len(served)
        out["_status"] = {s: sum(1 for r in snap["requests"] if r[4] == s)
                          for s in ("served", "shed", "failed")}
    elif kind == "explore":
        out["assign.chunks_per_design"] = c["assign.chunks"] / work["designs"]
        out["sweep.volume_useful_pct"] = 100 * c["sweep.volume_live"] / c["sweep.volume_padded"]
    else:
        out["single.assign_ms_per_design"] = 1e3 * sum(dur(sp, "single.assign")) / work["designs"]
    # per-design/per-request time of every program span name
    unit = work.get("designs") or work.get("requests")
    names = sorted({s[0] for s in sp})
    out["_span_ms_per_unit"] = {n: 1e3 * sum(dur(sp, n)) / unit for n in names}
    out["_span_counts"] = {n: sum(1 for s in sp if s[0] == n) for n in names}
    out["_counters"] = c
    out["_work"] = {k: v for k, v in work.items() if not isinstance(v, list)}
    return out


def trace_cell(cell, seed, seconds, tiny):
    device = torch.device("cpu" if tiny else "cuda")
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    kind, gen = make_gen(cell, seed, seconds, device, tiny)
    t_s = time.perf_counter()
    gen.setup()
    sync()
    setup_s = time.perf_counter() - t_s
    rids, gen_t0 = [], None
    spans = Spans(sync)
    restore = spans.install()
    clock = None
    if kind == "serve":
        import nspubench.generators.serve as gs

        svc = gen.svc
        orig = svc.submit

        def submit(*a, **k):
            h = orig(*a, **k)
            rids.append(h.id)
            return h

        svc.submit = submit

        class Clock:
            """The generator's clock, keeping its first reading (its t0)."""
            first = None

            def perf_counter(self):
                t = time.perf_counter()
                if self.first is None:
                    self.first = t
                return t

            def sleep(self, s):
                time.sleep(s)

        clock = Clock()
        gs.time = clock
    prof = None
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    obs.reset()
    obs.enable()
    epm = time.time_ns() - time.perf_counter_ns()
    t0 = time.perf_counter()
    gen.window(seconds)
    sync()
    t1 = time.perf_counter()
    obs.disable()
    if prof is not None:
        prof.__exit__(None, None, None)
    restore()
    if kind == "serve":
        gs.time = time
        gen_t0 = clock.first
        del gen.svc.submit
    snap = obs.snapshot()
    summ = gen.summary()
    res = {"cell": cell, "seed": seed, "setup_s": setup_s, "window_s": t1 - t0,
           "metrics": summ["metrics"], "attempted": summ["attempted"], "failed": summ["failed"],
           "kernels_in_window": snap["kernels"]}
    if kind == "serve":
        assert len(rids) == len(gen.due), (len(rids), len(gen.due))
    res["readings"] = readings(kind, snap, summ["work"], gen_t0, rids, gen)
    if prof is not None:
        dt = reduce_trace(prof, t0, t1, epm, spans)
        res["busy_s"], res["breakdown"] = dt.busy_s, dt.breakdown
        res["n_kernels"] = dt.n_kernels
        gaps = device_gaps(prof, t0, t1, epm)
        mids = [((a + b) / 2 - epm) / 1e9 for a, b in gaps]
        labels = innermost(snap["spans"], mids)
        by = {}
        for (a, b), lab in zip(gaps, labels):
            lab = lab or "(outside every program span)"
            by[lab] = by.get(lab, 0.0) + (b - a) / 1e9
        idle = sum(by.values())
        res["idle_s"] = idle
        res["idle_by_program_span"] = sorted(by.items(), key=lambda kv: -kv[1])
        res["idle_entry_level_share_pct"] = 100 * sum(v for k, v in by.items() if k in ENTRY) / idle
        inside = idle - by.get("(outside every program span)", 0.0)
        res["idle_entry_level_share_of_inside_pct"] = (
            100 * sum(v for k, v in by.items() if k in ENTRY) / inside if inside else 0.0)
        prof = None
    gen.release()
    if on_card:
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    chk = gen.check(full=False)
    res["check_s"] = time.perf_counter() - t_c
    res["checks"] = {k: v for k, v in chk["checks"].items()}
    res["correct"] = all(v <= lim for v, lim in chk["checks"].values())
    return res


def cost_cell(cell, seed, seconds, tiny):
    device = torch.device("cpu" if tiny else "cuda")
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    kind, gen = make_gen(cell, seed, seconds, device, tiny)
    gen.setup()
    sync()
    runs = []
    for mode in ("off", "on", "on", "off", "off", "on"):
        if kind == "explore":
            gen.jobs = []
        elif kind == "fit":
            gen.outputs = []
        obs.reset()
        if mode == "on":
            obs.enable()
        gen.window(seconds)
        sync()
        obs.disable()
        n_spans = len(obs.snapshot()["spans"])
        runs.append({"mode": mode, "metrics": gen.summary()["metrics"], "spans": n_spans})
        obs.reset()
    med = {}
    for mode in ("off", "on"):
        ms = [r["metrics"] for r in runs if r["mode"] == mode]
        med[mode] = {k: statistics.median(m[k] for m in ms) for k in ms[0]}
    delta = {k: 100 * (med["on"][k] / med["off"][k] - 1) for k in med["off"]}
    return {"cell": cell, "seed": seed, "seconds": seconds, "runs": runs,
            "median": med, "delta_pct_on_vs_off": delta}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("trace", "cost"))
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    fn = trace_cell if a.what == "trace" else cost_cell
    res = fn(a.cell, a.seed, a.seconds, a.tiny)
    if not a.tiny:
        res["card"] = R.card_line()
    text = json.dumps(res, default=str)
    if a.out:
        pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
