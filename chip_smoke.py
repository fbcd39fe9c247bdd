#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Runs from the root of a checkout on a host with one NVIDIA H100 (sm_90)
and the CUDA toolkit.  Imports the port (``src/repro_torch``) only, never
JAX or the JAX package.  Phases, each of which asserts:

1. build: both CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source, in parallel), with nvcc's ``-Xptxas -v`` lines;
2. the fused-step kernel against its plain PyTorch version (D = 1 at
   WordSynonyms and Lightning2, D = 4 heterogeneous; wta_k 1 and 2;
   stabilizer on and off): winner times and weights bit-equal;
3. the RNL-fire kernel against its plain version (B = 905 at 270 x 25,
   B = 121 at 637 x 2): equal;
4. the main path: ``simulator.cluster_time_series`` on all seven Table II
   designs, full synthetic doubles, 8 epochs, under mode='auto' and
   mode='pallas', with launch counters read around it; WordSynonyms and
   Lightning2 again on the CPU from the same initial weights, which must
   give the same assignments and Rand index;
5. timing at the main path's shapes with CUDA events, beside each
   kernel's bound on the card.

The line before the last is the kernels line (JSON); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
EPOCHS = 8
CPU_CHECKED = ("WordSynonyms", "Lightning2")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing
class Timer:
    """Device time of back-to-back launches: a sleep kernel holds the
    stream while the host enqueues the timed calls, so CUDA events see
    the device's time and not the host's enqueue overhead."""

    def __init__(self, torch):
        self.torch = torch
        t = torch
        t.cuda.synchronize()
        s, e = t.cuda.Event(enable_timing=True), t.cuda.Event(enable_timing=True)
        s.record()
        t.cuda._sleep(10_000_000)
        e.record()
        t.cuda.synchronize()
        self.cycles_per_ms = 10_000_000 / s.elapsed_time(e)

    def __call__(self, fn, reps: int, warmup: int = 3) -> float:
        t = self.torch
        for _ in range(warmup):
            fn()
        t.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t.cuda.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3
        s, e = t.cuda.Event(enable_timing=True), t.cuda.Event(enable_timing=True)
        t.cuda._sleep(int(2 * host_ms * self.cycles_per_ms) + 1000)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        t.cuda.synchronize()
        return s.elapsed_time(e) / reps


def fire_ops(p: int, t_fire, t_max: int) -> int:
    """min+add pairs the fire needs for these inputs: every synapse, for
    each cycle up to and including the first crossing (all t_max cycles
    for a neuron that never fires)."""
    cycles = (t_fire.long() + 1).clamp(max=t_max)
    return int(2 * p * int(cycles.sum()))


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    b = n_bytes / HBM_BYTES_PER_S * 1e3
    o = n_ops / F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


# ------------------------------------------------------------------ main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.tnn_columns import all_benchmarks, column_config
    from repro_torch.core import column, simulator
    from repro_torch.data import ucr
    from repro_torch.kernels import build, fused_column, rnl_response

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {torch.cuda.get_device_capability(0)}")

    # 1 — build
    t0 = time.perf_counter()
    build.build_all(build.KERNELS)
    log(f"[build] {len(build.KERNELS)} kernels in {time.perf_counter() - t0:.1f}s")
    for k in build.KERNELS:
        for line in k.ptxas_log.splitlines():
            if "ptxas" in line:
                log(f"[build] {k.name}: {line.strip()}")

    err = {k.name: 0.0 for k in build.KERNELS}

    # 2 — fused step against its plain version
    def fused_case(d, p, q, seed, hetero):
        rng = np.random.default_rng(seed)
        w = rng.integers(0, 15, (d, p, q)).astype(np.float32) / 2
        w = np.clip(w + rng.uniform(0, 0.01, w.shape).astype(np.float32)
                    * (rng.random(w.shape) < 0.3), 0, 7)
        t_in = rng.integers(0, 72, (d, p)).astype(np.float32)
        if hetero:
            thr = rng.uniform(0.1, 0.4, d) * p * 3.5
            tm = rng.integers(32, 65, d)
            qa = rng.integers(1, q + 1, d)
            mus = (rng.choice([0.5, 1.0, 0.25], d), rng.choice([0.5, 1.0], d),
                   rng.choice([1 / 1024, 0.5], d))
        else:
            thr, tm, qa = [0.25 * p * 3.5] * d, [64] * d, [q] * d
            mus = (0.5, 0.5, 1 / 1024)
        ops = fused_column.design_operands(thr, tm, qa, *mus)
        return torch.from_numpy(w), torch.from_numpy(t_in), ops

    for d, p, q, k_, stab, hetero in (
        (1, 270, 25, 1, True, False), (1, 270, 25, 2, False, False),
        (1, 637, 2, 1, True, False), (1, 637, 2, 2, False, False),
        (4, 270, 25, 2, True, True), (4, 270, 25, 1, False, True),
    ):
        w, t_in, ops = fused_case(d, p, q, seed=d * 1000 + p + q + k_, hetero=hetero)
        kw = dict(t_window=64, w_max=7, wta_k=k_, stabilize=stab)
        w_ref, y_ref = fused_column.fused_step_padded_plain(w, t_in, ops, **kw)
        w_k, y_k = fused_column.fused_step_padded(
            w.to(dev), t_in.to(dev), ops.to(dev), **kw)
        torch.cuda.synchronize()
        dw = float((w_k.cpu() - w_ref).abs().max())
        dy = float((y_k.cpu() - y_ref).abs().max())
        err["fused_step"] = max(err["fused_step"], dw, dy)
        log(f"[fused_step] D={d} {p}x{q} k={k_} stabilize={stab} "
            f"max|dw|={dw} max|dy|={dy}")
        assert torch.equal(y_k.cpu(), y_ref), "fused_step: winner times differ"
        assert torch.equal(w_k.cpu(), w_ref), "fused_step: weights differ"

    # 3 — RNL fire against its plain version
    for b, p, q in ((905, 270, 25), (121, 637, 2)):
        rng = np.random.default_rng(b)
        w = torch.from_numpy(rng.integers(0, 15, (p, q)).astype(np.float32) / 2)
        t_in = torch.from_numpy(rng.integers(0, 72, (b, p)).astype(np.int32))
        thr = 0.25 * p * 3.5
        ref = rnl_response.rnl_fire_plain(t_in, w, thr, 64, 7)
        got = rnl_response.rnl_fire(t_in.to(dev), w.to(dev), thr, 64, 7)
        torch.cuda.synchronize()
        diff = float((got.cpu() - ref).abs().max())
        err["rnl_fire"] = max(err["rnl_fire"], diff)
        log(f"[rnl_fire] B={b} {p}x{q} max|dt|={diff}")
        assert torch.equal(got.cpu(), ref), "rnl_fire: firing times differ"

    # 4 — the main path, launch counters reset just before it
    designs = {}
    for name in all_benchmarks():
        cfg = column_config(name)
        cfg = cfg.with_threshold(simulator.suggest_threshold(cfg))
        ds = ucr.load(name)
        w0 = column.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        designs[name] = (cfg, ds, w0)

    # one short untimed run per mode, so that the first design's
    # train_seconds does not carry PyTorch's lazy start-up on the card;
    # the counts are reset after it
    cfg, ds, w0 = designs["ECG200"]
    for mode in ("auto", "pallas"):
        simulator.cluster_time_series(ds.x[:16], ds.y[:16], cfg, epochs=1,
                                      mode=mode, seed=0, device="cuda", params=w0)

    for k in build.KERNELS:
        k.launches = 0
    results = {}
    for mode in ("auto", "pallas"):
        for name, (cfg, ds, w0) in designs.items():
            before = {k.name: k.launches for k in build.KERNELS}
            res = simulator.cluster_time_series(
                ds.x, ds.y, cfg, epochs=EPOCHS, mode=mode, seed=0,
                device="cuda", params=w0,
            )
            grew = {k.name: k.launches - before[k.name] for k in build.KERNELS}
            results[(name, mode)] = res
            n = ds.x.shape[0]
            log(f"[main] {name} {cfg.p}x{cfg.q} N={n} mode={mode} "
                f"RI={res.rand_index!r} train_seconds={res.train_seconds!r} "
                f"lowering={res.lowering} launches={grew} card={card}")
            assert res.lowering == "cuda"
            assert res.assignments.shape == (n,)
            assert np.all((res.assignments >= 0) & (res.assignments <= cfg.q))
            assert bool(torch.isfinite(res.params["w"]).all())
            assert 0.0 <= res.rand_index <= 1.0
            assert grew["fused_step"] == n * EPOCHS, grew
            if mode == "pallas":
                assert grew["rnl_fire"] >= 1, grew
            else:
                assert grew["rnl_fire"] == 0, grew
    launches = {k.name: k.launches for k in build.KERNELS}
    log(f"[main] launches over the main path: {launches}")
    for k in build.KERNELS:
        assert launches[k.name] > 0, f"{k.name} never launched on the main path"

    for name in CPU_CHECKED:
        cfg, ds, w0 = designs[name]
        for mode in ("auto", "pallas"):
            cpu = simulator.cluster_time_series(
                ds.x, ds.y, cfg, epochs=EPOCHS, mode=mode, seed=0,
                device="cpu", params=w0,
            )
            gpu = results[(name, mode)]
            same = bool(np.array_equal(cpu.assignments, gpu.assignments))
            log(f"[cpu-check] {name} mode={mode} equal_assignments={same} "
                f"RI cpu={cpu.rand_index!r} card={gpu.rand_index!r} "
                f"weights equal={torch.equal(cpu.params['w'], gpu.params['w'].cpu())}")
            assert cpu.lowering == "reference"
            assert same, f"{name} {mode}: card and CPU assignments differ"
            assert cpu.rand_index == gpu.rand_index

    # 5 — timing at the main path's shapes
    timer = Timer(torch)
    rows = {}
    for name, (cfg, ds, _) in designs.items():
        res = results[(name, "pallas")]
        w = res.params["w"].contiguous()
        x = simulator._encode(
            torch.as_tensor(ds.x, dtype=torch.float32, device=dev), cfg, "latency")
        p, q, t_max = cfg.p, cfg.q, cfg.t_max
        # fused step: one volley (the first series) on the trained weights
        w3 = w[None].contiguous()
        xt = x[:1].to(torch.float32).contiguous()
        ops = fused_column.design_operands(
            [cfg.neuron.threshold], [t_max], [q], cfg.stdp.mu_capture,
            cfg.stdp.mu_backoff, cfg.stdp.mu_search, device=dev)
        kw = dict(t_window=t_max, w_max=cfg.neuron.w_max, wta_k=cfg.wta.k,
                  stabilize=cfg.stdp.stabilizer == "half")
        f_ms = timer(lambda: fused_column.fused_step_padded(w3, xt, ops, **kw), 400)
        f_plain = timer(lambda: fused_column.fused_step_padded_plain(w3, xt, ops, **kw), 100)
        wi = torch.round(torch.clamp(w, 0, float(cfg.neuron.w_max)))
        t1 = fused_column.fire_dense_ref(wi, xt[0], cfg.neuron.threshold, t_max)
        # bytes: w read + written, volley, operands, y; operations: the
        # fire's min+add pairs, and ~10 per synapse for the STDP update
        f_bytes = 4 * (2 * p * q + p + 6 + q)
        f_ops = fire_ops(p, t1, t_max) + 10 * p * q
        # RNL fire: the main path's assignment call, every volley
        r_ms = timer(lambda: rnl_response.rnl_fire(x, w, cfg.neuron.threshold,
                                                   t_max, cfg.neuron.w_max), 50)
        r_plain = timer(lambda: rnl_response.rnl_fire_plain(
            x, w, cfg.neuron.threshold, t_max, cfg.neuron.w_max), 5, warmup=1)
        tf = rnl_response.rnl_fire_plain(x, w, cfg.neuron.threshold, t_max,
                                         cfg.neuron.w_max)
        n = x.shape[0]
        r_bytes = 4 * (n * p + p * q + n * q)
        r_ops = fire_ops(p, tf, t_max)
        rows[name] = dict(
            fused=(f_ms, f_plain, *bound_ms(f_bytes, f_ops), f_bytes, f_ops),
            rnl=(r_ms, r_plain, *bound_ms(r_bytes, r_ops), r_bytes, r_ops, n),
        )
        log(f"[time] {name} {p}x{q} fused_step ms={f_ms!r} plain_ms={f_plain!r} "
            f"bound_ms={rows[name]['fused'][2]!r} ({rows[name]['fused'][3]}) | "
            f"rnl_fire B={n} ms={r_ms!r} plain_ms={r_plain!r} "
            f"bound_ms={rows[name]['rnl'][2]!r} ({rows[name]['rnl'][3]}) | {card}")

    # 6 — the kernels line (shapes: WordSynonyms, the widest column)
    wsr = rows["WordSynonyms"]
    entries = []
    n_ws = wsr["rnl"][6]
    for k, key, shape in ((build.FUSED_STEP, "fused", "D=1 270x25 t_max=64"),
                          (build.RNL_FIRE, "rnl", f"B={n_ws} 270x25 t_max=64")):
        r = wsr[key]
        entries.append({
            "name": k.name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces.split()[0], "launches": launches[k.name],
            "max_abs_err": err[k.name], "ms": r[0], "plain_ms": r[1],
            "bound_ms": r[2], "bound_by": r[3], "library_ms": None,
            "shape": shape,
        })
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
