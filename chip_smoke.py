#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Runs from the root of a checkout on a host with one NVIDIA H100 (sm_90)
and the CUDA toolkit.  Imports the port (``src/repro_torch``) only, never
JAX or the JAX package.  Phases, each of which asserts:

1. build: all seven CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel), with nvcc's ``-Xptxas -v`` lines;
2. the fused-step kernel against its plain PyTorch version: one volley
   (D = 1 at WordSynonyms and Lightning2, D = 4 heterogeneous; wta_k 1
   and 2; stabilizer on and off; D = 2 at 650 x 130, which runs in the
   kernel's device-memory layout; f32 and int32 times), then whole fits
   folded in one launch (D = 1 and D = 4 heterogeneous; p 65, 270, 637,
   650 and 4000; N 1, 7 and 900; 0, 1 and 3 epochs; int32 volleys (the
   slope histogram), float volleys with non-integer times and int32
   volleys with negative times (the ramp sum); trace on and off; both
   layouts): winner times, trace and weights bit-equal;
3. the RNL-fire kernel against its plain version (B = 905 at 270 x 25,
   B = 121 at 637 x 2, B = 121 at 650 x 130 in the device-memory
   layout; int32 times (the slope histogram), f32 x + 0.5 and int32
   times with negative ones (the ramp sum), and a batch with one
   negative volley (both forms in one launch)): equal; once phase 7 has
   run, again on each of its 'pallas' calls' own inputs, whose times
   must reach the kernel as int32;
4. the volley-block kernel (its fire the integer slope histogram)
   against its plain version (D = 1 and D = 4 heterogeneous envelopes,
   v_blk 1, 7 and 32 with tails, wta_k 1 and 2, stabilizer on and off, a
   threshold-0 design with a tail, D = 2 at 650 x 130 in the
   device-memory layout; a D = 12 block of the on/off 540 x 50 envelope
   at v_blk 32, and a D = 4 block of a 1000 x 40 envelope, which the
   wrapper folds as sub-launches of the volleys that fit in shared
   memory): weights bit-equal, sub-launches as computed from the
   kernel's shared-memory formula;
5. the batched-fire kernel against its plain version (D = 4
   heterogeneous, N = 905 at 270 x 50 and 637 x 2, N = 121 at 650 x 130
   in the device-memory layout; the four kinds of times of phase 3, the
   mixed launch with negative times in one design only): times and ids
   equal; once phase 8 has run, again on the very inputs of each of the
   integer-grid sweep's launches (each bucket's trained weights and
   int32 volleys); and the float-weight fire kernel against its plain
   version on the inputs of each of phase 11's launches (times and ids);
6. the STDP-update kernel against its plain version (13 x 3, 270 x 25,
   650 x 130, 7 x 1 and 540 x 50; stabilizer on and off; int32 and f32
   times with silent entries; weights outside [0, 7] and at x.5): equal;
7. the single-column path: ``simulator.cluster_time_series`` on all
   seven Table II designs, full synthetic doubles, 8 epochs, under
   mode='auto' and mode='pallas', with launch counters read around it
   (one fused-step launch per fit) and the RNL-fire calls recorded;
   WordSynonyms and Lightning2 again on the CPU from the same initial
   weights, which must give the same assignments and Rand index;
8. the sweep path, launch counters read around it: two 12-design
   ``simulator.cluster_time_series_many`` sweeps over WordSynonyms (full
   width and N, 8 epochs; default STDP, then integer-grid STDP in buckets
   of 8), ``simulator.assign_time_series`` on one integer-grid design,
   and a two-layer ``simulator.cluster_time_series_network``;
9. the sweep path on the CPU from the same initial weights (two designs
   of each sweep, and the network): equal assignments, Rand index and
   weights;
10. the ``ops`` path, launch counters read around it: WordSynonyms
    (270 x 25, all 900 volleys, default STDP, one epoch) through the
    unfused loop ``ops.column_forward`` -> ``ops.stdp_step`` (RNL fire and
    STDP update, one launch each per volley, the path's int32 times read
    by the STDP kernel as they are) and through ``ops.train_volleys`` (one
    fused-step launch for all 900 volleys): weights bit-equal to each
    other and to ``train_volleys`` on the CPU;
11. the DSE path, launch counters read around it: ``dse.explore`` over
    the full WordSynonyms stream, 24 candidates (q 25/50 x t_max 32/64 x
    three threshold scales x latency/on-off encoders), 4 epochs: nothing
    quarantined or retried, every point on 'cuda', the volley-block
    launches as computed, one float-weight fire launch a bucket; again with a journal cut after its first
    bucket and resumed: bit-identical; and one candidate of each encoder
    (the on/off one at 540 x 50) on the CPU from the same initial
    weights: equal ids, Rand index and weights;
12. the hardware generator (host only): the chosen design through
    ``hwgen.run_flow`` to TNN7 post-layout metrics, and the seven
    Table II ``hardware_spec`` flows;
13. the Lightning2 sweep, launch counters read around it:
    ``simulator.cluster_time_series_many`` over the Lightning2 synthetic
    double (p 637, full N) at q 25 and 50 x two thresholds, 2 epochs,
    ``on_error='raise'``, in the layout the kernel's shared-memory formula
    gives the 637 x 50 envelope (resident: 143,348 B beside the weights);
    then on the CPU from the same initial weights: nothing quarantined,
    equal ids, Rand index and weights;
14. the flash-attention kernel against its plain version on the card
    (f32 at the JAX package's test shapes, < 2e-5 of the largest output;
    the granite-3-8b prefill shape in bf16 (the tensor-core kernel),
    < 2e-2, and in f32 (the CUDA-core kernel), < 2e-5; a ragged S = 1000,
    a non-causal and an MHA case); each case also per element against the
    plain version in f32 on the same values, within one rounding to its
    dtype plus 1e-5 of the largest output; and, per element, bf16 at tile
    edges where a consumer warpgroup has no rows or skips tiles (Sq 1
    against Skv 1000, Sq 63, 65, 129, 1000, Skv != Sq);
15. the LM slice at full width, 2 layers: granite-3-8b in f32, B 1, a
    100-token prompt and 4 decode steps, card logits (the kernel) against
    a float64 CPU reference (the plain version) from the same weights,
    < 1e-4 of the largest, TF32 off; the JAX package's serve-matches-forward property
    (prefill of 6 tokens + 6 decode steps against the forward) on the
    card, in f32 < 3e-3, and in bf16 within two bf16 steps of the
    largest logit for three weight seeds (the JAX package's own bf16
    error is 1.4-1.7 steps);
16. the LM serving path, launch counters read around it:
    ``repro_torch.launch.serve.serve`` on granite-3-8b at full width and
    depth (40 layers, bf16, random weights from a seed), batch 4, prompt
    2048, 16 tokens: 40 flash launches per prefill, finite logits, peak
    device memory, prefill and decode times (then again, warm);
17. timing at the paths' shapes with CUDA events, beside each kernel's
    bound on the card: the fused-step kernel on each Table II design's
    whole fit in one launch (ms per launch, us per volley; at
    WordSynonyms beside the plain fold over the same fit and the fit's
    bound, recounted volley by volley in the slope form), and on one
    volley with int32 and with f32 times; the volley-block kernel on the
    default sweep's first launch (D = 12 at 270 x 50, v_blk = 32; bound
    by the slope form's operations, the ramp sum's printed beside it),
    the RNL fire on each Table II design's volleys and the batched fire
    on each of the integer-grid sweep's launches (the kernels line sums
    them), both on the path's int32 times (bound by the slope form's
    operations) and on the same times as f32 (the ramp sum's bound
    beside it), the STDP update on the ops path's first volley (its
    int32 times, and as f32) and at the phase 6 shapes, the four fire
    kernels at 650 x 130 in the device-memory layout (the two
    frozen-weight ones on int32 and on f32 times), the float-weight fire
    on phase 11's on/off launch (D = 12 at 540 x 50, N = 900, beside its
    plain version and its bound in the slope form), and the flash kernel
    at the granite prefill
    shape beside its plain version and PyTorch's
    ``scaled_dot_product_attention`` (bound by the operations of its
    split-P products, the two products' alone printed beside it); then
    the flash kernel at the LM families' shapes, each held per element
    against its plain version and printed beside it, SDPA and its bound:
    one kimi-k2 and one zamba2 prefill layer (head dim 112, B 4 x 2048,
    GQA 64:8 and MHA 32), one whisper encoder layer (1500 frames,
    non-causal) and whisper's decode cross-attention (Sq 1 over 1500);
    then the SSD scan kernel (bf16) at the zamba2-7b-instruct.docs4k
    prefill's shape (B 8 x 4,032, H 112, G 2, N 64, dh 64, chunks of
    256) through ``ssd_chunked``, held to its plain version per element
    and in the norm (``repro_torch.testing.ssd``), beside the plain
    version and its bound (bytes: x, B, C, dt in, y and the state out);
    then the causal conv kernel (bf16) at the same prefill's shape (B 8 x
    4,032, C 7,424, the in_proj output's x | B | C columns, with the
    layer's bias) through ``_causal_conv``, bit-equal to its plain
    version (out and new state), beside the plain version and its bound
    (bytes: u in, out written once); then the decode step's two kernels
    (bf16) at a mamba layer of each LM cell (B 8: the docs4k cell's H 112,
    G 2, N 64 and the rag2k cell's H 128, G 1, N 128) through
    ``_one_token``, the states bit-equal to its plain version and y within
    ``repro_torch.testing.ssm_step``'s bound, timed beside their bound
    (bytes: S in and out, the window, z and y), ``_one_token`` and
    ``_one_token_plain`` with the cell's out_proj, and that product alone.

18. the TNN serving path, launch counters read around it: the streaming
    ``serve.ClusteringService`` over the seven Table II designs at
    published widths (four envelope buckets), integer-grid STDP from
    integer weights, every series of their synthetic doubles (3,426
    requests) round-robin, batch 16, a re-fit every 64 requests of a
    bucket over windows of 32: all served, nothing failed, shed, isolated
    or degraded; each batch one fire_block launch and each re-fit the
    fused_block launches of ``block_sub_launches``, nothing else launched
    or built; requests/s, latency p50/p99, ms per batch and re-fit; the
    same service on the CPU (equal ids, bit-equal weights); a frozen copy
    against ``simulator.assign_time_series``; a durable run dropped
    without a drain after half the stream, recovered on the card and on
    the CPU (bit-identical weights) and fed the rest; the two kernels
    against their plain versions on recorded serving calls and timed at
    each bucket's serving shape; a default-STDP fleet, card against CPU;
    ``python -m repro_torch.launch.serve_tnn --smoke`` (its own SIGTERM,
    a drain, exit 0).

20. the paper's Table II on the card, launch counters read around it: the
    seven designs at published widths on their synthetic doubles, the
    settings of benchmarks/table2_clustering.py (the first 240 series, 4
    epochs, ``suggest_threshold``, DTCR at 60 steps): the port's
    ``kmeans`` (labels equal to the CPU's), ``cluster_time_series`` in
    mode='pallas' (one fused-step launch per fit, RNL-fire assignment;
    ids equal to the CPU's) and ``dtcr.fit_predict`` (one step's loss
    and gradients within 1e-4 of the largest of the CPU's from the same
    parameters, TF32 off; the full fits on the card within about 90 s,
    each cut of steps printed, and on the CPU in worker processes, the
    Rand index of their labels printed; one step on the shortest series
    under ``torch.profiler``: the device's idle share); per design the
    three Rand indices, the normalized TNN and DTCR beside the paper's,
    the TNN ``train_seconds``, the k-means seconds and the DTCR seconds a
    step;

22. the LM families on the card, launch counters read around each model:
    ``launch.serve.serve`` at full width (bf16, random weights from a
    seed), batch 4, prompt 2048, 16 tokens, cold then warm, for olmoe-1b-7b
    (16 layers), kimi-k2-1t-a32b (full width, 1 of its 61 layers: the
    cut is printed), mamba2-370m (48), zamba2-7b (81), whisper-medium (24 +
    24, zero frames) and qwen2-vl-7b (28): flash launches per prefill
    (16, 1, 0, 13, 72, 28; whisper 24 more per decode step, its
    cross-attention), SSD scan and causal conv launches per prefill
    (mamba2-370m 48, zamba2-7b 81 each: one a mamba layer; none a decode
    step), nothing else
    launched, prefill ms, decode ms per
    token, peak device memory, and one prefill and four decode steps
    under ``torch.profiler`` (device busy and idle share); then each
    family at full width, depth cut to hold one attention application
    (2 layers; zamba2 7, one superblock of 6 and a tail block; whisper 2
    + 2; kimi's experts cut to 16 on both sides, printed), f32, a 32-token
    prompt and 4 decode steps, card logits against a float64 CPU
    reference of the same weights < 1e-4 of the largest (MoE: the router
    ids of every layer, card against CPU, first); and on those card
    models the JAX package's serve-matches-forward property in f32 <
    3e-3 for every family but MoE (printed, not held: at decode cap_e is
    1 and the reference itself drops colliding assignments).
    The phase prints its own seconds.

23. LM training on the card, no flash launch in any training run (the
    training forward takes ``chunked_attention``): (a) each of the ten
    smoke configs, one f32 step (the optimizer of its full config: kimi
    Adafactor, the rest AdamW; the Trainer's default schedule) on the
    card against the CPU from the same weights (zamba2's LoRA b_q drawn,
    not zeros) and batch, TF32 off: loss within 1e-5,
    every updated leaf within 1e-5 of its largest entry, the MoE router's
    ids equal; (b) granite-3-8b at full width, 1 layer, f32, B 1 x S 256:
    loss, gradient norm and each gradient leaf against a float64 CPU
    reference, < 1e-4 relative; (c) granite-3-8b at full width, 4 of its
    40 layers (printed), bf16, remat, AdamW, B 4 x S 2048: 8 steps with
    finite losses (host-clock ms a step, median of the warm steps, ended
    by the loss reaching the host; tokens/s; peak device memory), one
    more step under ``torch.profiler`` (device busy and idle share, top 4
    kernels), ``chunked_attention`` timed alone at the layer's shapes (its
    share of the step's device time), microbatches 2 against 1 over 3
    steps within 2e-3, and a run preempted after 3 steps restored from
    its checkpoint, its losses equal to the straight run's within rtol
    1e-5, atol 1e-6 (bit-equality printed); (d) the granite smoke pillar:
    30 steps at lr 2e-3, losses fall, then prefill and decode from the
    trained model, finite; (e) ``launch.train --smoke`` as a subprocess.
    The phase prints its own seconds.

24. the dry run (``repro_torch.launch.dryrun``: DTensors of fake tensors
    on a fake process group, no kernel launched): (a) phase 23's cell,
    granite-3-8b at full width, 4 of 40 layers, bf16, remat, AdamW, B 4 x
    S 2048, on a (1, 1) mesh, then the same step once on the card: the dry
    run's FLOPs equal ``FlopCounterMode``'s count of the card's step and
    its argument bytes the card's parameters, AdamW state and batch,
    exactly; its peak (argument + temp + output - alias) within 10% of
    ``max_memory_allocated`` across that step (reset just before it); its
    roofline terms under a profile of a bf16 ``torch.matmul`` rate (8192^3,
    CUDA events) and a streaming bandwidth (an elementwise add, CUDA
    events), ``roofline_fraction``
    <= 1.05, printed beside phase 23's step time; the same step once more
    under the dry run's counter on the card's tensors (its peak printed:
    what the tracker sees of the real step); (b) five production cells at
    full width on fake tensors, each in its own process, all at once:
    granite-3-8b train_4k (single and multi), olmoe-1b-7b train_4k,
    mamba2-370m long_500k and kimi-k2-1t-a32b decode_32k: status ok,
    collective bytes above 0, argument bytes equal to the local shard
    bytes of the specs; per-device memory, FLOPs, bytes, collective bytes
    by kind and the analysis row printed.  The phase prints its own
    seconds.

Phases 20, 22, 23 and 24 run after phase 18, before the kernels line (19).
The line before the last is the kernels line (JSON); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense, on the tensor cores
EPOCHS = 8
DSE_EPOCHS = 4
CPU_CHECKED = ("WordSynonyms", "Lightning2")
STDP_SHAPES = ((13, 3), (270, 25), (650, 130), (7, 1), (540, 50))
# candidates checked on the CPU: q 50, t_max 64, threshold scale 1.0,
# latency (270 x 50) and on/off (540 x 50)
DSE_CPU_CHECKED = (10, 22)
# the LM serving path: granite-3-8b's prefill shape
LM_ARCH, LM_BATCH, LM_PROMPT, LM_TOKENS = "granite-3-8b", 4, 2048, 16
# phase 22: (arch id, layers served (None: all), flash launches per prefill,
# per decode step, SSD scan and causal conv launches per prefill: one of
# each a mamba layer, and two ssm_step launches a mamba layer a decode step)
FAMILY_SERVING = (
    ("olmoe-1b-7b", None, 16, 0, 0),
    ("kimi-k2-1t-a32b", 1, 1, 0, 0),  # 61 layers of 384 experts: ~2 TB in bf16
    ("mamba2-370m", None, 0, 0, 48),
    ("zamba2-7b", None, 13, 0, 81),
    ("whisper-medium", None, 72, 24, 0),
    ("qwen2-vl-7b", None, 28, 0, 0),
)
# card against float64 CPU: the depth that holds one attention application
FAMILY_CHECK_LAYERS = {"zamba2-7b": 7}  # the rest: 2 (whisper 2 + 2)
FAMILY_CHECK_PROMPT = 32
KIMI_CHECK_EXPERTS = 16  # 384 experts in float64 would not fit the host
# phase 23: LM training at full width, depth cut
TRAIN_ARCH, TRAIN_FULL_LAYERS, TRAIN_LAYERS = "granite-3-8b", 40, 4
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_STEPS, TRAIN_MICRO_STEPS, TRAIN_PREEMPT = 8, 3, 3
# phase 24: the dry run; (b)'s production cells, each its own process
DRY_CELLS = (
    ("granite-3-8b", "train_4k", "single"),
    ("olmoe-1b-7b", "train_4k", "single"),
    ("mamba2-370m", "long_500k", "single"),
    ("kimi-k2-1t-a32b", "decode_32k", "single"),
    ("granite-3-8b", "train_4k", "multi"),
)
DRY_PEAK_TOL = 0.10


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


def fire_ops(p: int, t_fire, t_max, live=None) -> int:
    """min+add pairs the fire needs for these inputs: every synapse, for
    each cycle up to and including the first crossing (all t_max cycles
    for a neuron that never fires).  ``t_max`` is a number or a tensor
    broadcast against ``t_fire``; ``live`` masks out neurons the fire
    skips (those at or past q_active)."""
    import torch

    t_max = torch.as_tensor(t_max, device=t_fire.device).long()
    cycles = torch.minimum(t_fire.long() + 1, t_max)
    if live is not None:
        cycles = cycles * live
    return int(2 * p * int(cycles.sum()))


def bound_ms(n_bytes: int, n_ops: int,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    b = n_bytes / HBM_BYTES_PER_S * 1e3
    o = n_ops / ops_per_s * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def layout_name(kernel, *dims) -> str:
    """The layout the kernel's wrapper picks at these dimensions."""
    return "resident" if kernel.resident("", *dims) else "device-memory layout"


# ------------------------------------------------- the padded kernels
def half_grid(rng, shape):
    """Weights on the half-integer grid with some off-grid jitter: x.5
    values are routine under mu = 0.5 and are where rounding modes
    disagree."""
    import numpy as np

    w = rng.integers(0, 15, shape).astype(np.float32) / 2
    jitter = rng.uniform(0, 0.01, shape).astype(np.float32) * (rng.random(shape) < 0.3)
    return np.clip(w + jitter, 0, 7)


# (d, p, q, v_blk, n_valid, wta_k, stabilize)
BLOCK_CASES = (
    (1, 270, 50, 32, 32, 1, True),
    (1, 270, 50, 32, 9, 2, False),
    (4, 270, 50, 32, 20, 2, True),
    (4, 270, 50, 7, 7, 1, False),
    (4, 637, 2, 7, 4, 2, True),
    (4, 270, 25, 1, 1, 1, True),
    (4, 637, 2, 32, 32, 1, False),
    (2, 650, 130, 32, 20, 1, True),   # the device-memory layout
)


def check_fused_block(fused_column, dev) -> float:
    """Phase 4: the volley-block kernel against its plain version; returns
    the largest difference (0 when it passes)."""
    import numpy as np
    import torch

    from repro_torch.kernels import build

    worst = 0.0
    for case in BLOCK_CASES + ((2, 40, 6, 4, 2, 1, False),):
        d, p, q, v_blk, n_valid, k, stab = case
        degenerate = case == (2, 40, 6, 4, 2, 1, False)
        rng = np.random.default_rng(d * 1000 + p + q + v_blk + n_valid)
        t_window = 16 if degenerate else 64
        w = torch.from_numpy(half_grid(rng, (d, p, q)))
        t_in = rng.integers(0, t_window + 8, (d, v_blk, p)).astype(np.float32)
        thr = rng.uniform(0.1, 0.4, d) * p * 3.5
        tm = rng.integers(t_window // 2, t_window + 1, d)
        qa = rng.integers(max(1, q // 2), q + 1, d)
        tm[-1], qa[0] = t_window, q
        if degenerate:  # threshold 0 fires a silent volley: only n_valid masks it
            thr[:] = 0.0
            t_in[:, n_valid:] = t_window
        mus = (rng.choice([0.5, 1.0], d), rng.choice([0.5, 1.0], d),
               rng.choice([1 / 1024, 0.5], d))
        ops = fused_column.design_operands(thr, tm, qa, *mus)
        t_in = torch.from_numpy(t_in)
        kw = dict(t_window=t_window, w_max=7, wta_k=k, stabilize=stab)
        ref = fused_column.fused_block_padded_plain(w, t_in, ops, n_valid, **kw)
        got = fused_column.fused_block_padded(
            w.to(dev), t_in.to(dev), ops.to(dev), n_valid, **kw).cpu()
        dw = float((got - ref).abs().max())
        worst = max(worst, dw)
        log(f"[fused_block] D={d} {p}x{q} v_blk={v_blk} n_valid={n_valid} "
            f"k={k} stabilize={stab} threshold0={degenerate} max|dw|={dw} "
            f"{layout_name(build.FUSED_BLOCK, p, q, 1, t_window)}")
        assert torch.equal(got, ref), "fused_block: weights differ"
        if degenerate:
            unmasked = fused_column.fused_block_padded_plain(w, t_in, ops, v_blk, **kw)
            assert not torch.equal(unmasked, ref), "tail case does not test the mask"
    return worst


def check_fire_block(fused_column, dev) -> float:
    """Phase 5: the batched-fire kernel against its plain version (on the
    card, on the same tensors), times and ids, on int32 times (the slope
    histogram), f32 x + 0.5 and int32 with negative times (the ramp sum),
    and ``mixed`` (negative times in design 0 only: one launch, both
    forms); returns the largest difference."""
    import numpy as np
    import torch

    from repro_torch.kernels import build

    worst = 0.0
    for n, p, q in ((905, 270, 50), (905, 637, 2), (121, 650, 130)):
        d = 4
        rng = np.random.default_rng(n + p + q)
        w = torch.from_numpy(half_grid(rng, (d, p, q))).to(dev)
        tm = torch.tensor([64.0, 40.0, 33.0, 64.0], device=dev)
        qa = torch.tensor([float(q), max(1.0, q - 3.0), 1.0, float(q)], device=dev)
        ops = fused_column.design_operands(
            rng.uniform(0.1, 0.4, d) * p * 3.5, tm.cpu().numpy(), qa.cpu().numpy(),
            0.0, 0.0, 0.0, device=dev)
        for kind in ("int", "half", "neg", "mixed"):
            xs = torch.from_numpy(fit_volleys(rng, kind, (d, n, p), 64)).to(dev)
            if kind == "mixed":
                assert bool((xs[0] < 0).any()) and bool((xs[1:] >= 0).all())
            ref = fused_column.fire_block_padded_plain(w, xs, ops, t_window=64, w_max=7)
            got = fused_column.fire_block_padded(w, xs, ops, t_window=64, w_max=7)
            ids = fused_column._ids_from_times(got, tm, qa)
            ids_ref = fused_column._ids_from_times(ref, tm, qa)
            dt = float((got - ref).abs().max())
            worst = max(worst, dt)
            log(f"[fire_block] D={d} N={n} {p}x{q} {kind} times={xs.dtype} "
                f"max|dt|={dt} ids equal={torch.equal(ids, ids_ref)} "
                f"{layout_name(build.FIRE_BLOCK, p, q, 64)}")
            assert torch.equal(got, ref), "fire_block: firing times differ"
            assert torch.equal(ids, ids_ref), "fire_block: ids differ"
    return worst


def sweep_designs(ColumnConfig, STDPConfig, simulator, grid: bool):
    """12 WordSynonyms designs as dse.space.candidate_config builds them:
    q x t_max x threshold scale times suggest_threshold."""
    stdp = (STDPConfig(mu_capture=1.0, mu_backoff=1.0, mu_search=1.0,
                       stabilizer="none") if grid else STDPConfig())
    cfgs = []
    for q in (25, 50):
        for t_max in (32, 64):
            for scale in (0.75, 1.0, 1.25):
                c = ColumnConfig(p=270, q=q, t_max=t_max, stdp=stdp)
                cfgs.append(c.with_threshold(scale * simulator.suggest_threshold(c)))
    return cfgs


def sweep_w_init(cfgs, grid: bool, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    if grid:
        return [rng.integers(0, 8, (c.p, c.q)).astype(np.float32) for c in cfgs]
    return [rng.uniform(0, 7, (c.p, c.q)).astype(np.float32) for c in cfgs]


def padded_sweep_inputs(simulator, fused_column, cfgs, w_list, x):
    """The operands ``simulator._sweep_bucket`` builds for one bucket of
    all ``cfgs``: weights [D, p, q_env], volleys [D, N, p] f32 (each
    design's own encoding), operands [D, 6]."""
    import torch

    d, q_env = len(cfgs), max(c.q for c in cfgs)
    p = cfgs[0].p
    w = torch.zeros((d, p, q_env), device=x.device)
    for j, (c, wj) in enumerate(zip(cfgs, w_list)):
        w[j, :, : c.q] = torch.as_tensor(wj, device=x.device)
    xs = torch.stack([simulator._encode(x, c, "latency") for c in cfgs]).float()
    c0 = cfgs[0]
    ops = fused_column.design_operands(
        [c.neuron.threshold for c in cfgs], [c.t_max for c in cfgs],
        [c.q for c in cfgs], c0.stdp.mu_capture, c0.stdp.mu_backoff,
        c0.stdp.mu_search, device=x.device)
    return w.contiguous(), xs.contiguous(), ops


def record_calls(module, name: str, sink: list):
    """Wrap ``module.name`` so that every call keeps a copy of its
    arguments in ``sink``; returns the function that unwraps it."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        sink.append(([a.clone() if hasattr(a, "clone") else a for a in args],
                     dict(kwargs)))
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def check_path_fire_calls(fused_column, calls, name: str = "fire_block") -> float:
    """Phase 5, second half: a frozen-weight fire kernel (``fire_block``,
    or ``fire_float``) against its plain version on the inputs that its
    path gave it; returns the largest difference."""
    import torch

    kernel = getattr(fused_column, f"{name}_padded")
    plain = getattr(fused_column, f"{name}_padded_plain")
    worst = 0.0
    for (w, xs, ops), kw in calls:
        assert xs.dtype == torch.int32, ("the path's volleys reach the kernel as", xs.dtype)
        got = kernel(w, xs, ops, **kw)
        ref = plain(w, xs, ops, **kw)
        ids = fused_column._ids_from_times(got, ops[:, 1], ops[:, 2])
        ids_ref = fused_column._ids_from_times(ref, ops[:, 1], ops[:, 2])
        dt = float((got - ref).abs().max())
        worst = max(worst, dt)
        d, n, p = xs.shape
        log(f"[{name}] path launch D={d} N={n} {p}x{w.shape[2]} times={xs.dtype} "
            f"max|dt|={dt} ids equal={torch.equal(ids, ids_ref)}")
        assert torch.equal(got, ref), f"{name}: firing times differ on the path"
        assert torch.equal(ids, ids_ref), f"{name}: ids differ on the path"
    return worst


def scatter_ops(x, g, t_end, live) -> int:
    """Adds of the slope form's scatter for volleys x [N, p] on the grid g
    [p, q]: one for each live synapse whose ramp rises inside [0, t_end),
    one more where it tops out there (``live`` [q] bool)."""
    ti = x.float()[:, :, None]
    up = (ti >= 0) & (ti < t_end) & (g > 0) & live
    return int(up.sum()) + int((up & (ti + g < t_end)).sum())


def rnl_bound(rnl_response, x, w, threshold, t_max, w_max) -> tuple[int, int, int]:
    """Bytes and operations of one RNL-fire launch on these inputs: times
    and weights read once, firing times written once.  Operations in the
    slope form (the scatter's adds, and two adds a cycle for each neuron's
    scan up to its crossing, as ``block_bound`` counts them), then in the
    ramp sum (``fire_ops``)."""
    import torch

    b, p = x.shape
    q = w.shape[1]
    tf = rnl_response.rnl_fire_plain(x, w, threshold, t_max, w_max)
    g = torch.round(torch.clamp(w, 0.0, float(w_max)))
    live = torch.ones(q, dtype=torch.bool, device=w.device)
    slope = scatter_ops(x, g, t_max, live) + fire_ops(1, tf, t_max)
    return 4 * (b * p + p * q + b * q), slope, fire_ops(p, tf, t_max)


def fire_bound(fused_column, w, xs, ops, kw) -> tuple[int, int, int]:
    """Bytes and operations of one batched-fire launch on these inputs:
    volleys, weights and operands read once, times written once.
    Operations in the slope form, then in the ramp sum (min+add pairs of
    every live neuron up to its crossing), as ``rnl_bound`` counts them;
    t_end = min(t_window, ceil(t_max)) for each design."""
    import math

    import torch

    d, n, p = xs.shape
    q = w.shape[2]
    tf = fused_column.fire_block_padded_plain(w, xs, ops, **kw)
    live = (torch.arange(q, device=w.device) < ops[:, 2:3, None]).long()
    g = torch.round(torch.clamp(w, 0.0, float(kw["w_max"])))
    n_scatter = sum(
        scatter_ops(xs[k], g[k], min(kw["t_window"], math.ceil(float(ops[k, 1]))),
                    live[k, 0].bool())
        for k in range(d))
    n_bytes = 4 * (d * n * p + d * p * q + d * 6 + d * n * q)
    t_max = ops[:, 1:2, None]
    return (n_bytes, n_scatter + fire_ops(1, tf, t_max, live),
            fire_ops(p, tf, t_max, live))


def float_fire_bound(fused_column, w, xs, ops, t_window) -> tuple[int, int]:
    """Bytes and operations of one float-weight fire launch on these
    inputs: volleys, weights and operands read once, times written once.
    Operations in the slope form, as ``fire_bound`` counts them with
    ceil(w) for the grid weight: one add for each live synapse with w > 0
    whose ramp starts inside [0, t_end), one more where it tops out there
    (the final step), and two a cycle for each live neuron's scan up to
    its crossing."""
    import math

    import torch

    d, n, p = xs.shape
    q = w.shape[2]
    tf = fused_column.fire_float_padded_plain(w, xs, ops, t_window=t_window)
    live = (torch.arange(q, device=w.device) < ops[:, 2:3, None]).long()
    n_scatter = 0
    for k in range(d):
        t_end = min(t_window, math.ceil(float(ops[k, 1])))
        ti = xs[k].float()[:, :, None]
        up = (ti >= 0) & (ti < t_end) & (w[k] > 0) & live[k, 0].bool()
        n_scatter += int(up.sum()) + int((up & (ti + torch.ceil(w[k]) <= t_end)).sum())
    n_bytes = 4 * (d * n * p + d * p * q + d * 6 + d * n * q)
    return n_bytes, n_scatter + fire_ops(1, tf, ops[:, 1:2, None], live)


def block_bound(fused_column, w, blk, ops, kw) -> tuple[int, int, int]:
    """Bytes and operations of one volley-block launch on these inputs:
    the weights read and written once, the volleys and operands read
    once.  Operations volley by volley on the weights each volley sees,
    in the kernel's slope-histogram form: one add for each live synapse
    whose ramp rises inside the window and one more where it tops out
    there, two adds a cycle for each live neuron's scan up to its
    crossing, and ~10 per live synapse for its STDP.  The third number is
    the same work counted as the ramp sum that the other fire kernels
    compute (min+add pairs of every synapse each cycle up to the
    crossing, and the same STDP)."""
    import torch

    d, p, q = w.shape
    v_blk = blk.shape[1]
    n_bytes = 4 * (2 * d * p * q + d * v_blk * p + d * 6)
    tm, qa = ops[:, 1:2, None], ops[:, 2:3, None]
    live = (torch.arange(q, device=w.device) < qa).long()
    t_end = torch.clamp(torch.ceil(tm), max=float(kw["t_window"]))
    n_ops = n_ramp = 0
    for vi in range(v_blk):
        one = blk[:, vi : vi + 1].contiguous()
        t = fused_column.fire_block_padded_plain(
            w, one, ops, t_window=kw["t_window"], w_max=kw["w_max"])
        stdp = 10 * p * int(live.sum())
        g = torch.round(torch.clamp(w, 0.0, float(kw["w_max"])))
        ti = one[:, 0, :, None]
        up = (ti >= 0) & (ti < t_end) & (g > 0) & live.bool()
        down = up & (ti + g < t_end)
        n_ops += int(up.sum()) + int(down.sum()) + fire_ops(1, t, tm, live) + stdp
        n_ramp += fire_ops(p, t, tm, live) + stdp
        w = fused_column.fused_block_padded_plain(w, one, ops, 1, **kw)
    return n_bytes, n_ops, n_ramp


def check_block_split(fused_column, build, dev) -> float:
    """Phase 4, last cases: a D = 12 block of the on/off 540 x 50 envelope
    and a D = 4 block of a 1000 x 40 envelope at v_blk 32, each launched
    as the sub-blocks that fit in shared memory by the kernel's own
    formula (one launch at 540 x 50, two at 1000 x 40), bit-equal to the
    plain fold of the whole block.  Returns the largest difference."""
    import numpy as np
    import torch

    worst = 0.0
    for d, p, q, v_blk, n_valid in ((12, 540, 50, 32, 30), (4, 1000, 40, 32, 30)):
        rng = np.random.default_rng(p)
        w = torch.from_numpy(half_grid(rng, (d, p, q)))
        t_in = torch.from_numpy(rng.integers(0, 72, (d, v_blk, p)).astype(np.float32))
        ops = fused_column.design_operands(
            rng.uniform(0.1, 0.4, d) * p * 3.5, rng.integers(32, 65, d),
            rng.integers(25, q + 1, d), 0.5, 0.5, 1 / 1024)
        kw = dict(t_window=64, w_max=7, wta_k=1, stabilize=True)
        plan = fused_column.block_sub_launches(p, q, v_blk, n_valid, 64)
        one = build.FUSED_BLOCK.smem_bytes(p, q, v_blk, 64)
        ref = fused_column.fused_block_padded_plain(w, t_in, ops, n_valid, **kw)
        before = build.FUSED_BLOCK.launches
        got = fused_column.fused_block_padded(
            w.to(dev), t_in.to(dev), ops.to(dev), n_valid, **kw).cpu()
        launched = build.FUSED_BLOCK.launches - before
        dw = float((got - ref).abs().max())
        worst = max(worst, dw)
        v_fit = plan[0][1]
        log(f"[fused_block] split D={d} {p}x{q} v_blk={v_blk} n_valid={n_valid}: "
            f"{one} B at one launch (at most {build.MAX_SMEM_BYTES}); sub-launches "
            f"{[v for _, v, _ in plan]} launched={launched} max|dw|={dw}")
        assert (len(plan) > 1) == (one > build.MAX_SMEM_BYTES), plan
        assert build.FUSED_BLOCK.smem_bytes(p, q, v_fit, 64) <= build.MAX_SMEM_BYTES
        assert launched == len(plan) == -(-min(n_valid, v_blk) // v_fit), (launched, plan)
        assert torch.equal(got, ref), "fused_block: the split block differs"
    return worst


def fit_volleys(rng, kind, shape, t_max):
    """int32 times with silent ones (>= t_max), the same shifted by a half
    (f32, non-integer), int32 times down to -8, or (``mixed``) int32
    times down to -8 in the first design only."""
    import numpy as np

    if kind == "int":
        return rng.integers(0, t_max + 8, shape).astype(np.int32)
    if kind == "half":
        return (rng.integers(0, t_max + 8, shape) + 0.5).astype(np.float32)
    x = rng.integers(-8, t_max + 8, shape).astype(np.int32)
    if kind == "mixed":
        x[1:] = np.abs(x[1:])
    return x


# (d, p, q, n, epochs, volleys, trace, wta_k, stabilize)
FIT_CASES = (
    (1, 270, 25, 900, 1, "int", True, 1, True),    # WordSynonyms, a whole epoch
    (4, 270, 25, 7, 3, "int", True, 2, True),
    (4, 270, 25, 7, 3, "neg", True, 1, False),
    (4, 270, 25, 7, 3, "mixed", True, 2, True),    # a fire form per design
    (4, 65, 40, 7, 3, "half", True, 1, True),      # q wider than a warp
    (1, 637, 2, 7, 3, "int", False, 1, True),      # Lightning2
    (1, 637, 50, 7, 3, "neg", True, 2, True),
    (2, 650, 130, 7, 1, "int", True, 1, True),     # the device-memory layout
    (2, 650, 130, 7, 1, "half", False, 2, False),
    (2, 650, 130, 7, 1, "mixed", True, 1, True),
    (1, 4000, 16, 7, 3, "neg", True, 1, True),     # the device-memory layout
    (1, 4000, 8, 1, 1, "int", True, 2, True),
    (4, 96, 5, 7, 0, "int", True, 1, True),        # no epoch
)


def check_fused_fit(fused_column, build, dev) -> float:
    """Phase 2, second half: whole fits folded in one launch of the
    fused-step kernel against the plain fold (heterogeneous designs where
    D > 1); returns the largest difference."""
    import numpy as np
    import torch

    worst = 0.0
    for d, p, q, n, epochs, kind, trace, k, stab in FIT_CASES:
        rng = np.random.default_rng(d * 1000 + p + q + n + epochs)
        w = torch.from_numpy(half_grid(rng, (d, p, q)))
        xs = torch.from_numpy(fit_volleys(rng, kind, (d, n, p), 64))
        tm = rng.integers(32, 65, d)
        qa = rng.integers(1, q + 1, d)
        tm[0], qa[0] = 64, q
        ops = fused_column.design_operands(
            rng.uniform(0.1, 0.4, d) * p * 3.5, tm, qa,
            rng.choice([0.5, 1.0, 0.25], d), rng.choice([0.5, 1.0], d),
            rng.choice([1 / 1024, 0.5], d))
        kw = dict(epochs=epochs, t_window=64, w_max=7, wta_k=k, stabilize=stab,
                  trace=trace)
        w_ref, y_ref = fused_column.fused_fit_padded_plain(w, xs, ops, **kw)
        before = build.FUSED_STEP.launches
        w_k, y_k = fused_column.fused_fit_padded(w.to(dev), xs.to(dev), ops.to(dev), **kw)
        torch.cuda.synchronize()
        launched = build.FUSED_STEP.launches - before
        dw = float((w_k.cpu() - w_ref).abs().max())
        dy = float((y_k.cpu() - y_ref).abs().max()) if trace and y_ref.numel() else 0.0
        worst = max(worst, dw, dy)
        log(f"[fused_step] fit D={d} {p}x{q} N={n} epochs={epochs} {kind} "
            f"trace={trace} k={k} stabilize={stab} launches={launched} max|dw|={dw} "
            f"max|dy|={dy} {layout_name(build.FUSED_STEP, p, q, 64)}")
        assert launched == 1, launched
        assert (y_k is None) == (not trace)
        if trace:
            assert torch.equal(y_k.cpu(), y_ref), "fused_step: the fit's trace differs"
        assert torch.equal(w_k.cpu(), w_ref), "fused_step: the fit's weights differ"
    return worst


def fit_bound(fused_column, w, xs, ops, kw, last=False) -> tuple[int, int, int]:
    """Bytes and operations of one whole-fit launch of the fused-step
    kernel for one design on these inputs: the weights read and written
    once, each volley and the operands read once, the trace (with
    ``kw['trace']``) or the last winner times (``last``) written once.
    Operations volley by volley on the weights each volley sees (replayed
    one volley at a time by the kernel), in the slope-histogram form as
    ``block_bound`` counts them; the third number is the same work as the
    ramp sum."""
    import torch

    _, n, p = xs.shape
    q = w.shape[2]
    epochs, t_window, w_max = kw["epochs"], kw["t_window"], kw["w_max"]
    step = dict(t_window=t_window, w_max=w_max, wta_k=kw["wta_k"],
                stabilize=kw["stabilize"])
    n_out = epochs * n * q if kw.get("trace") else (q if last else 0)
    n_bytes = 4 * (2 * p * q + n * p + 6 + n_out)
    thr, tm, qa = ops[:, 0:1], ops[:, 1:2], ops[:, 2:3]
    live = torch.arange(q, device=w.device) < qa  # [1, q]
    t_end = torch.clamp(torch.ceil(tm), max=float(t_window))[..., None]
    n_edges = torch.zeros((), dtype=torch.int64, device=w.device)
    n_cycles = torch.zeros((), dtype=torch.int64, device=w.device)
    for _ in range(epochs):
        for i in range(n):
            one = xs[:, i].contiguous()
            g = torch.round(torch.clamp(w, 0.0, float(w_max)))
            t = fused_column.fire_dense_ref(g, one, thr, t_window, tm).long()
            ti = one[:, :, None].float()
            up = (ti >= 0) & (ti < t_end) & (g > 0) & live[:, None, :]
            down = up & (ti + g < t_end)
            n_edges += up.sum() + down.sum()
            n_cycles += (torch.minimum(t + 1, tm.long()) * live).sum()
            w, _ = fused_column.fused_step_padded(w, one, ops, **step)
    stdp = 10 * p * int(live.sum()) * epochs * n
    return (n_bytes, int(n_edges) + 2 * int(n_cycles) + stdp,
            2 * p * int(n_cycles) + stdp)


def stdp_inputs(p, q, dtype, seed):
    """Weights from uniform(0, 7), a few outside [0, 7] and at x.5; times
    of ``dtype`` with silent entries (>= t_max 64) on both axes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 7, (p, q)).astype(np.float32)
    extra = np.array([-0.5, 7.5, 3.5, 0.5, 9.0, 6.5], np.float32)
    w.flat[: min(w.size, extra.size)] = extra[: w.size]
    x = torch.from_numpy(rng.integers(0, 72, p)).to(dtype)
    y = torch.from_numpy(rng.integers(0, 72, q)).to(dtype)
    x[0], y[-1] = 64, 70
    return torch.from_numpy(w), x, y


def check_stdp_update(stdp_update, dev) -> float:
    """Phase 6: the STDP-update kernel against its plain version; returns
    the largest difference."""
    import torch

    worst = 0.0
    for p, q in STDP_SHAPES:
        for stab in (True, False):
            for dtype in (torch.int32, torch.float32):
                w, x, y = stdp_inputs(p, q, dtype, seed=p * 7 + q)
                args = (0.5, 0.5, 1 / 1024, 7, 64, stab)
                ref = stdp_update.stdp_update_plain(w, x, y, *args)
                got = stdp_update.stdp_update(
                    w.to(dev), x.to(dev), y.to(dev), *args).cpu()
                dw = float((got - ref).abs().max())
                worst = max(worst, dw)
                log(f"[stdp_update] {p}x{q} stabilize={stab} times={dtype} "
                    f"max|dw|={dw}")
                assert torch.equal(got, ref), "stdp_update: weights differ"
    return worst


def stdp_bound(p: int, q: int) -> tuple[int, int]:
    """Bytes and operations of one STDP update: weights read and written
    once, the two time vectors read once (4 B each); ~10 operations per
    synapse (compares, selects, the stabilizer's products, the clamp)."""
    return 8 * p * q + 4 * p + 4 * q, 10 * p * q


def n_valid_per_block(n: int, v_blk: int) -> list:
    return [min(v_blk, n - v_blk * i) for i in range(-(-n // v_blk))]



# ------------------------------------------------------ the LM slice
def rel_err(got, want) -> float:
    """Largest difference relative to the largest reference value."""
    got, want = got.float(), want.float().to(got.device)
    return float((got - want).abs().max() / want.abs().max())


def repair_sweep(simulator, ColumnConfig, build, ucr, dev, card) -> None:
    """Phase 13: the Lightning2 sweep at q 25 and 50 (a 637 x 50 envelope,
    in the layout the kernel's formula gives it) on the card, launch
    counters read around it, then on the CPU from the same initial
    weights."""
    import numpy as np
    import torch

    ds = ucr.load("Lightning2")
    n, p = ds.x.shape
    cfgs = []
    for q in (25, 50):
        for scale in (1.0, 1.25):
            c = ColumnConfig(p=p, q=q, t_max=64)
            cfgs.append(c.with_threshold(scale * simulator.suggest_threshold(c)))
    rng = np.random.default_rng(637)
    w_init = [rng.uniform(0, 7, (c.p, c.q)).astype(np.float32) for c in cfgs]
    one = build.FUSED_BLOCK.smem_bytes(p, 50, 1, 64)
    layout = layout_name(build.FUSED_BLOCK, p, 50, 1, 64)
    assert build.FUSED_BLOCK.resident("", p, 50, 1, 64) == (one <= build.MAX_SMEM_BYTES)
    for k in build.KERNELS:
        k.launches = 0
    res = simulator.cluster_time_series_many(
        ds.x, ds.y, cfgs, epochs=2, w_init=w_init, on_error="raise", device=dev)
    launches = {k.name: k.launches for k in build.KERNELS}
    log(f"[repair] Lightning2 {p}x(25,50) N={n} 2 epochs: one volley needs {one} B "
        f"beside the weights ({layout}); buckets={res[0].buckets} "
        f"train_seconds={res[0].train_seconds!r} launches={launches} | {card}")
    assert launches["fused_block"] > 0, launches
    t0 = time.perf_counter()
    cpu = simulator.cluster_time_series_many(
        ds.x, ds.y, cfgs, epochs=2, w_init=w_init, on_error="raise", device="cpu")
    for c, r, rc in zip(cfgs, res, cpu):
        assert isinstance(r, simulator.ClusteringResult), r  # not quarantined
        assert r.lowering == "cuda" and r.retries == 0, (r.lowering, r.retries)
        same_a = bool(np.array_equal(r.assignments, rc.assignments))
        same_w = torch.equal(r.params["w"].cpu(), rc.params["w"])
        log(f"[repair] q={c.q} threshold={c.neuron.threshold} RI card="
            f"{r.rand_index!r} cpu={rc.rand_index!r} equal_ids={same_a} "
            f"weights equal={same_w} cpu_seconds={time.perf_counter() - t0:.1f}")
        assert same_a and same_w and r.rand_index == rc.rand_index


# (B, Sq, Hq, Hkv, d, causal, dtype, tolerance relative to the largest output)
FLASH_CASES = (
    (2, 256, 4, 2, 64, True, "float32", 2e-5),   # the JAX package's test shapes,
    (1, 128, 2, 1, 32, False, "float32", 2e-5),  # with grouped KV heads
    (2, 384, 3, 1, 128, True, "float32", 2e-5),
    (1, 512, 1, 1, 64, True, "float32", 2e-5),
    (LM_BATCH, LM_PROMPT, 32, 8, 128, True, "bfloat16", 2e-2),  # granite prefill
    (LM_BATCH, LM_PROMPT, 32, 8, 128, True, "float32", 2e-5),  # its grid in f32
    (2, 1000, 32, 8, 128, True, "float32", 2e-5),  # ragged
    (1, 1000, 8, 2, 128, False, "bfloat16", 2e-2),  # non-causal
    (1, 512, 8, 8, 128, True, "float32", 2e-5),  # MHA
)


def flash_inputs(b, sq, hq, hkv, d, dtype, dev, seed=0, skv=None):
    import torch

    skv = sq if skv is None else skv
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype) for shape in (
        (b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))


# (Sq, Skv, causal) in bf16 at B 2, Hq 8, Hkv 2, d 64: tile edges where a
# consumer warpgroup of the tensor-core kernel has no rows or skips tiles
FLASH_EDGES = ((1, 1000, False), (63, 63, True), (129, 63, True),
               (65, 129, False), (1000, 1000, True))


def check_flash(flash_lib, dev) -> float:
    """Phase 14: the flash kernel against its plain version on the card;
    returns the largest absolute difference.

    Each case is held twice: relative to the largest output (the JAX
    package's tolerances), and per element against the plain version
    evaluated in f32 on the same values, within one rounding of the output
    to q's dtype (unit roundoff u) plus 1e-5 of the largest output for the
    f32 summation order.  The second is what holds the rows far from the
    largest output (row 0 is v[0]; most causal rows are ~50 times smaller).
    The bf16 plain version is not held per element: it rounds the
    probabilities to bf16 before the PV product and the kernel does not,
    which moves rows whose values cancel by more than a bf16 step."""
    import torch

    worst = 0.0
    for b, sq, hq, hkv, d, causal, dt, tol in FLASH_CASES:
        q, k, v = flash_inputs(b, sq, hq, hkv, d, getattr(torch, dt), dev, seed=sq + d)
        got = flash_lib.flash_attention(q, k, v, causal)
        ref = flash_lib.flash_attention_plain(q, k, v, causal)
        err = rel_err(got, ref)
        dmax = float((got.float() - ref.float()).abs().max())
        worst = max(worst, dmax)
        if dt == "float32":
            ref32, u = ref, 2.0 ** -24
        else:
            ref32 = flash_lib.flash_attention_plain(q.float(), k.float(), v.float(), causal)
            u = 2.0 ** -8
        bound = u * ref32.abs() + 1e-5 * ref32.abs().max()
        ratio = float(((got.float() - ref32).abs() / bound).max())
        rms = float(ref32.pow(2).mean().sqrt())
        log(f"[flash] B={b} S={sq} Hq={hq} Hkv={hkv} d={d} causal={causal} {dt}: "
            f"max|d|={dmax} relative to the largest={err} (< {tol}); per element "
            f"against f32, largest |d| / (u|ref| + 1e-5 max|ref|)={ratio} (<= 1, "
            f"u={u}, max|ref|={float(ref32.abs().max())}, rms(ref)={rms})")
        assert got.dtype == q.dtype and got.shape == q.shape
        assert err < tol, ("flash_attention differs from its plain version", err)
        assert ratio <= 1, ("flash_attention differs per element", ratio)
        del q, k, v, got, ref, ref32, bound
    for sq, skv, causal in FLASH_EDGES:
        q, k, v = flash_inputs(2, sq, 8, 2, 64, torch.bfloat16, dev, seed=sq + skv,
                               skv=skv)
        got = flash_lib.flash_attention(q, k, v, causal).float()
        ref32 = flash_lib.flash_attention_plain(q.float(), k.float(), v.float(), causal)
        bound = 2.0 ** -8 * ref32.abs() + 1e-5 * ref32.abs().max()
        ratio = float(((got - ref32).abs() / bound).max())
        worst = max(worst, float((got - ref32).abs().max()))
        log(f"[flash] edge B=2 Sq={sq} Skv={skv} Hq=8 Hkv=2 d=64 causal={causal} "
            f"bfloat16: per element against f32, largest |d| / (u|ref| + 1e-5 "
            f"max|ref|)={ratio} (<= 1)")
        assert ratio <= 1, ("flash_attention differs per element at an edge", sq, skv)
    return worst


def serve_vs_forward(T, model, toks, frames=None) -> tuple[float, float]:
    """The JAX package's property: prefill of half the tokens, then one
    decode step per token, against the forward: (the largest difference
    relative to the largest logit, the largest logit)."""
    import torch

    s = toks.shape[1]
    with torch.inference_mode():
        full = T.forward(model, toks, frames=frames)
        cache, lg = T.prefill(model, toks[:, : s // 2], max_len=s + 2, frames=frames)
        outs = [lg]
        for t in range(s // 2, s):
            cache, lg = T.decode_step(model, cache, toks[:, t : t + 1])
            outs.append(lg)
    return rel_err(torch.cat(outs, dim=1), full), float(full.float().abs().max())


def lm_slice_checks(T, cfg_full, dev) -> None:
    """Phase 15: the LM at full width, 2 layers: card logits (f32, the
    kernel) against a float64 reference of the same weights on the CPU
    (the plain version); the serve-matches-forward property on the card
    in f32 at its tolerance, and in bf16 within two bf16 steps of the
    largest logit.  The reference is float64 because the f32 CPU logits
    moved by up to ~1e-4 of the largest between processes on some chip
    hosts (PERF.md section 7)."""
    import dataclasses
    import math

    import torch

    cfg = dataclasses.replace(cfg_full, n_layers=2, dtype="float32")
    card_m = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(5),
                           device=dev)
    ref_m = T.params_from_jax(T.params_to_numpy(card_m), cfg, "cpu").double()
    toks = torch.randint(0, cfg.vocab_size, (1, 104),
                         generator=torch.Generator().manual_seed(6))
    runs = ((card_m, dev), (ref_m, "cpu"))
    t0 = time.perf_counter()
    with torch.inference_mode():
        steps = [[T.prefill(m, toks[:, :100].to(d), max_len=110) for m, d in runs]]
        for t in range(100, 104):
            steps.append([T.decode_step(m, c, toks[:, t : t + 1].to(d))
                          for (c, _), (m, d) in zip(steps[-1], runs)])
    logits = [[lg for _, lg in step] for step in steps]
    errs = [rel_err(card, ref) for card, ref in logits]
    log(f"[lm] {cfg.name} full width, 2 layers, f32: card logits vs the float64 "
        f"CPU reference, relative to the largest, prefill(100) then 4 decode "
        f"steps: {errs} (< 1e-4; {time.perf_counter() - t0:.1f}s)")
    assert max(errs) < 1e-4, errs
    assert all(bool(torch.isfinite(card).all()) for card, _ in logits)
    del ref_m, steps, logits

    # the JAX package's test_serve_matches_forward: B 2, 12 tokens, in its
    # own dtype (f32) and tolerance
    toks = torch.randint(0, cfg.vocab_size, (2, 12), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(8))
    err, _ = serve_vs_forward(T, card_m, toks)
    log(f"[lm] {cfg.name} full width, 2 layers, f32: serve vs forward logits "
        f"relative to the largest {err} (< 3e-3)")
    assert err < 3e-3, err
    del card_m

    # in bf16 the logits themselves are rounded to bf16, and one step of
    # bf16 at the largest logit (~5) is ~6e-3 of it: any difference of the
    # two paths' hidden states can move a logit by a step.  The JAX
    # package's own bf16 serve-vs-forward error is 1.4-1.7 such steps
    # (tests/test_torch_lm.py), so the bound is two steps.
    # Three weight seeds, each held to the bound, so the bound is not one
    # run's reading.
    cfg = dataclasses.replace(cfg_full, n_layers=2)  # bf16
    for seed in (7, 17, 27):
        model = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                              device=dev)
        err, mx = serve_vs_forward(T, model, toks)
        del model
        step = 2.0 ** (math.floor(math.log2(mx)) - 7) / mx
        log(f"[lm] {cfg.name} full width, 2 layers, bf16, weight seed {seed}: serve "
            f"vs forward logits relative to the largest {err} = {err / step} bf16 "
            f"steps of the largest logit {mx} (<= 2 steps: {2 * step})")
        assert err <= 2 * step, (seed, err, step)


# ------------------------------------------------------ TNN serving
SERVE_SEED = 11  # initial weights: SERVE_SEED (default STDP), + 1 (grid)
SERVE_BATCH = 16
SERVE_PROFILED = 800  # requests served under torch.profiler


def serving_fleet(grid: bool) -> tuple[dict, dict]:
    """The seven Table II designs at published widths (t_max 64,
    ``suggest_threshold``) and their initial weights from a seed: integer
    0-7 with integer-grid STDP (mus 1/1/1, no stabilizer), as phase 8's
    grid sweep; uniform floats with the default STDP."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.tnn_columns import all_benchmarks, column_config
    from repro_torch.core import simulator
    from repro_torch.core.types import STDPConfig

    rng = np.random.default_rng(SERVE_SEED + int(grid))
    fleet, weights = {}, {}
    for name in all_benchmarks():
        c = column_config(name)
        if grid:
            c = dataclasses.replace(c, stdp=STDPConfig(
                mu_capture=1.0, mu_backoff=1.0, mu_search=1.0, stabilizer="none"))
        fleet[name] = c.with_threshold(simulator.suggest_threshold(c))
        w = (rng.integers(0, c.neuron.w_max + 1, (c.p, c.q)) if grid
             else rng.uniform(0, c.neuron.w_max, (c.p, c.q)))
        weights[name] = w.astype(np.float32)
    return fleet, weights


def serving_stream(fleet, ucr) -> list:
    """Every series of each design's full synthetic double, round-robin
    across the designs: [(design, series)]."""
    xs = {name: ucr.load(name).x for name in fleet}
    out = []
    for k in range(max(len(x) for x in xs.values())):
        out += [(name, x[k]) for name, x in xs.items() if k < len(x)]
    return out


def serve_all(svc, stream) -> list:
    handles = [svc.submit(x, d) for d, x in stream]
    svc.flush()
    return handles


def assert_clean(svc, n: int) -> None:
    """Every request served: no failure, shed, isolation, failed re-fit
    or degraded bucket (a CUDA fault is sticky, so none may pass)."""
    st = svc.stats()
    assert (st.served, st.failed, st.shed, st.isolations, st.refit_failures,
            st.degraded, st.pending) == (n, 0, 0, 0, 0, 0, 0), st


def timed(fn, sink: list):
    """``fn`` with the host clock of each call appended to ``sink``."""
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        sink.append(time.perf_counter() - t0)
        return out
    return wrapper


def same_service(a, b, ha, hb, label: str) -> None:
    """Two services that took the same stream: equal ids request by
    request and bit-equal weights design by design."""
    import numpy as np

    ids_a = [h.result().cluster for h in ha]
    ids_b = [h.result().cluster for h in hb]
    same_w = all(np.array_equal(a.weights(d), b.weights(d)) for d in a.designs())
    log(f"[serve_tnn] {label}: ids equal={ids_a == ids_b} weights bit-equal={same_w}")
    assert ids_a == ids_b, label
    assert same_w, label


def tnn_serving(build, fused_column, simulator, ucr, dev, card, timer) -> dict:
    """Phase 18: the streaming clustering service at full width (the seven
    Table II designs in four envelope buckets, every series of their
    synthetic doubles), launch counters reset just before it and read
    just after.  Returns the kernels' timings at the serving shapes."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.serve import ClusteringService

    fleet, w0 = serving_fleet(grid=True)
    stream = serving_stream(fleet, ucr)
    n = len(stream)
    kw = dict(batch_size=SERVE_BATCH, weights=w0)  # re-fit every 64, window 32
    svc = ClusteringService(fleet, device=dev, **kw)
    warm = svc.warmup()
    for b in svc.buckets():
        log(f"[serve_tnn] envelope {b['envelope']} <- {b['designs']}")
    assert all(b.asg_lowering == b.fit_lowering == "cuda" for b in svc._buckets)

    # the path: counters to 0 just before, read just after; on the side the
    # re-fits' shapes, the host clock of each batch and re-fit, any build
    fits, t_batch, t_refit, builds = [], [], [], []
    orig_fit, orig_build = fused_column.fit_scan_padded, build.build_all

    def record_fit(w, xs, *a, **k):
        fits.append((tuple(w.shape), xs.shape[0], k["v_blk"], k["t_window"],
                     k["epochs"]))
        return orig_fit(w, xs, *a, **k)

    svc._assign = timed(svc._assign, t_batch)
    svc._fit_window = timed(svc._fit_window, t_refit)
    fused_column.fit_scan_padded = record_fit
    build.build_all = lambda *a, **k: builds.append(a) or orig_build(*a, **k)
    torch.cuda.synchronize()
    for k in build.KERNELS:
        k.launches = 0
    try:
        t0 = time.perf_counter()
        handles = serve_all(svc, stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in build.KERNELS}
    finally:
        fused_column.fit_scan_padded, build.build_all = orig_fit, orig_build
    st = svc.stats()
    want_block = sum(
        e * len(fused_column.block_sub_launches(p, q, v, min(v, r - s), tw))
        for (_, p, q), r, v, tw, e in fits for s in range(0, r, v))
    lat = sorted(h.result().latency_s for h in handles)
    out = dict(rps=n / wall, p50_ms=lat[n // 2] * 1e3,
               p99_ms=lat[min(n - 1, int(n * 0.99))] * 1e3,
               batch_ms=statistics.median(t_batch) * 1e3,
               refit_ms=statistics.median(t_refit) * 1e3)
    log(f"[serve_tnn] integer-grid fleet, {n} requests in {wall!r} s: "
        f"{out['rps']!r} requests/s, latency p50 {out['p50_ms']!r} ms p99 "
        f"{out['p99_ms']!r} ms; median ms per batch {out['batch_ms']!r} "
        f"({len(t_batch)} batches), per re-fit {out['refit_ms']!r} "
        f"({len(t_refit)} re-fits), host clock; warmup {warm['seconds']!r} s | {card}")
    log(f"[serve_tnn] launches={launches}; pinned: fire_block = batches = "
        f"{st.batches}, fused_block = the re-fits' block_sub_launches = "
        f"{want_block} over {st.refits} re-fits; builds after warmup {len(builds)}")
    assert_clean(svc, n)
    assert all(b.asg_lowering == "cuda" for b in svc._buckets)
    assert len(fits) == st.refits and not builds
    assert launches == {k.name: 0 for k in build.KERNELS} | {
        "fire_block": st.batches, "fused_block": want_block}, launches

    # where the time goes: the first SERVE_PROFILED requests on a fresh
    # service from the same weights, under torch.profiler
    from torch.profiler import ProfilerActivity, profile

    prof_svc = ClusteringService(fleet, device=dev, **kw)
    prof_svc.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_all(prof_svc, stream[:SERVE_PROFILED])
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t0) * 1e3
    busy, n_k = device_us(prof)
    fire_us, n_fire = device_us(prof, "fire_block_kernel")
    block_us, n_block = device_us(prof, "fused_block_kernel")
    out["profile"] = (wall_p, busy / 1e3, n_k)
    log(f"[profile] serving {SERVE_PROFILED} requests ({prof_svc.stats().batches} "
        f"batches, {prof_svc.stats().refits} re-fits): wall {wall_p!r} ms (profiled); "
        f"device busy {busy / 1e3!r} ms in {n_k} kernels, of which fire_block "
        f"{fire_us / 1e3!r} ms in {n_fire}, fused_block {block_us / 1e3!r} ms in "
        f"{n_block}; device idle share {1 - busy / 1e3 / wall_p!r} | {card}")
    del prof, prof_svc

    # the same service on the CPU, same weights and stream
    cpu = ClusteringService(fleet, device="cpu", **kw)
    cpu.warmup()
    same_service(svc, cpu, handles, serve_all(cpu, stream),
                 "integer-grid fleet, card vs CPU")
    del cpu

    # a frozen copy against simulator.assign_time_series on the card
    frozen = ClusteringService(fleet, device=dev, refit_every=0, **kw)
    frozen.warmup()
    hf = serve_all(frozen, stream)
    assert_clean(frozen, n)
    for name, cfg in fleet.items():
        got = [h.result().cluster for h, (d, _) in zip(hf, stream) if d == name]
        want = simulator.assign_time_series(ucr.load(name).x, cfg, {"w": w0[name]},
                                            device=dev)
        assert got == want.tolist(), name
    log("[serve_tnn] frozen copy (refit_every=0): ids equal to "
        "simulator.assign_time_series on the card for all seven designs")
    del frozen

    # durability: a durable run dropped without drain() after half the
    # stream (its kernel calls recorded), recovered on the card and on the
    # CPU; the recovered service then takes the rest
    half = n // 2
    with tempfile.TemporaryDirectory() as tmp:
        dur = ClusteringService(fleet, device=dev, durable_dir=f"{tmp}/svc", **kw)
        dur.warmup()
        fire_calls, block_calls = [], []
        undo = [record_calls(fused_column, "fire_block_padded", fire_calls),
                record_calls(fused_column, "fused_block_padded", block_calls)]
        try:
            for d, x in stream[:half]:
                dur.submit(x, d)
        finally:
            for u in undo:
                u()
        dst = dur.stats()
        live = {d: dur.weights(d) for d in fleet}
        del dur  # dropped: no drain, no final snapshot
        rec = ClusteringService.recover(f"{tmp}/svc", device=dev)
        rec_cpu = ClusteringService.recover(f"{tmp}/svc", device="cpu")
        for r in (rec, rec_cpu):
            assert r.stats().replayed == dst.wal_records
            for d in fleet:
                assert np.array_equal(r.weights(d), live[d]), (r.device, d)
        log(f"[serve_tnn] durable run dropped after {half} requests "
            f"({dst.refits} re-fits, {dst.snapshots} snapshots, WAL tail "
            f"{dst.wal_records}): recovered on the card and on the CPU, weights "
            f"bit-identical to the dropped service's")
        # the rest: the recovered service against a fresh one from the same
        # weights (a kill loses the served-but-unrefit buffers by contract)
        rec.warmup()
        fresh = ClusteringService(fleet, device=dev, batch_size=SERVE_BATCH,
                                  weights=live)
        fresh.warmup()
        rest = stream[half:]
        same_service(rec, fresh, serve_all(rec, rest), serve_all(fresh, rest),
                     f"recovered service, then the other {len(rest)} requests, vs "
                     f"a fresh service from the recovered weights")
        assert_clean(fresh, len(rest))

    # the two kernels against their plain versions on recorded serving
    # calls (one batch and one re-fit window per bucket), and timed
    rows = {"fire": [], "block": []}
    seen = set()
    for args, fkw in fire_calls:
        w, xs, ops = args
        if tuple(w.shape) in seen:
            continue
        seen.add(tuple(w.shape))
        check_path_fire_calls(fused_column, [((w, xs, ops), fkw)])
        g_ms = timer(lambda: fused_column.fire_block_padded(w, xs, ops, **fkw), 200)
        g_plain = timer(lambda: fused_column.fire_block_padded_plain(
            w, xs, ops, **fkw), 20)
        g_bytes, g_ops, g_ramp = fire_bound(fused_column, w, xs, ops, fkw)
        g_bound, g_by = bound_ms(g_bytes, g_ops)
        rows["fire"].append((tuple(w.shape), g_ms, g_plain, g_bound, g_by))
        d, nn, p = xs.shape
        log(f"[time] serving fire_block D={d} N={nn} {p}x{w.shape[2]} ms={g_ms!r} "
            f"plain_ms={g_plain!r} bound_ms={g_bound!r} ({g_by}; {g_bytes} B, {g_ops} "
            f"ops of the slope form; the ramp sum's {g_ramp}) | {card}")
    seen = set()
    for (w, blk, ops, nv), bkw in block_calls:
        if tuple(w.shape) in seen:
            continue
        seen.add(tuple(w.shape))
        got = fused_column.fused_block_padded(w, blk, ops, nv, **bkw)
        ref = fused_column.fused_block_padded_plain(w, blk, ops, nv, **bkw)
        d, v, p = blk.shape
        log(f"[fused_block] serving re-fit window D={d} v_blk={v} n_valid={nv} "
            f"{p}x{w.shape[2]} max|dw|={float((got - ref).abs().max())}")
        assert torch.equal(got, ref), "fused_block differs on a serving window"
        b_ms = timer(lambda: fused_column.fused_block_padded(w, blk, ops, nv, **bkw), 50)
        b_plain = timer(lambda: fused_column.fused_block_padded_plain(
            w, blk, ops, nv, **bkw), 3, warmup=1)
        b_bytes, b_ops, b_ramp = block_bound(fused_column, w, blk, ops, bkw)
        b_bound, b_by = bound_ms(b_bytes, b_ops)
        rows["block"].append((tuple(w.shape), b_ms, b_plain, b_bound, b_by))
        log(f"[time] serving re-fit fused_block D={d} v_blk={v} {p}x{w.shape[2]} "
            f"ms={b_ms!r} plain_ms={b_plain!r} bound_ms={b_bound!r} ({b_by}; "
            f"{b_bytes} B, {b_ops} ops of the slope form; the ramp sum's {b_ramp}) "
            f"| {card}")
    assert len(rows["fire"]) == len(rows["block"]) == len(svc.buckets())

    # the default-STDP fleet: float weights (the fire_float assignment),
    # re-fits on fused_block; card against CPU
    fleet_f, w_f = serving_fleet(grid=False)
    kw_f = dict(batch_size=SERVE_BATCH, weights=w_f)
    card_f = ClusteringService(fleet_f, device=dev, **kw_f)
    cpu_f = ClusteringService(fleet_f, device="cpu", **kw_f)
    card_f.warmup()
    cpu_f.warmup()
    assert all(b.asg_lowering == "reference" for b in card_f._buckets)
    t0 = time.perf_counter()
    h_card = serve_all(card_f, stream)
    wall_f = time.perf_counter() - t0
    assert_clean(card_f, n)
    log(f"[serve_tnn] default-STDP fleet, {n} requests in {wall_f!r} s: "
        f"{n / wall_f!r} requests/s, {card_f.stats().refits} re-fits | {card}")
    same_service(card_f, cpu_f, h_card, serve_all(cpu_f, stream),
                 "default-STDP fleet, card vs CPU")

    # the launcher, on the card, takes its own SIGTERM and drains
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_tnn", "--smoke"],
                       capture_output=True, text=True, cwd=ROOT, timeout=600,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    for line in r.stdout.splitlines():
        if not line.startswith("[serve_tnn] stats"):
            log(line)
    assert r.returncode == 0 and "drained cleanly" in r.stdout, r.stderr[-2000:]
    out.update(rows=rows, launches=launches)
    return out


# ---------------------------------------------------------------- Table II
TABLE2_N, TABLE2_EPOCHS, DTCR_STEPS = 240, 4, 60  # benchmarks/table2_clustering.py
DTCR_BUDGET_S = 90.0  # card seconds for the seven DTCR fits
DTCR_WORKERS = 4      # CPU processes fitting the CPU's DTCR copies


def dtcr_cpu_labels(args) -> tuple:
    """One DTCR fit on the CPU, in a worker process of its own: (labels,
    seconds)."""
    x, cfg_kw, params = args
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.clustering import dtcr

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    labels = dtcr.fit_predict(x, dtcr.DTCRConfig(**cfg_kw), device="cpu",
                              params=dtcr.params_from_jax(params, "cpu"))
    return labels, time.perf_counter() - t0


def dtcr_steps(est: dict) -> dict:
    """Steps per design within DTCR_BUDGET_S, from each design's measured
    seconds a step: the full DTCR_STEPS for the cheapest designs while
    that leaves 10 steps (the centers move once) for each of the rest,
    then the largest multiple of 10 that still does, 10 at least."""
    left, out = DTCR_BUDGET_S, {}
    order = sorted(est, key=est.get)
    for i, name in enumerate(order):
        rest = 10 * sum(est[n] for n in order[i + 1:])
        steps = min(DTCR_STEPS, int((left - rest) / est[name] / 10) * 10)
        out[name] = max(10, steps)
        left -= out[name] * est[name]
    return out


def table2(build, simulator, column, ucr, dev, card) -> None:
    """Phase 20: the paper's Table II on the card, the seven designs at
    their published widths on their synthetic doubles, with the settings
    of benchmarks/table2_clustering.py (the first 240 series, 4 epochs,
    suggest_threshold, DTCR at 60 steps): the port's k-means, the TNN
    column (``cluster_time_series``, mode='pallas') and DTCR, each on the
    card, beside the CPU from the same inputs.  Launch counters reset
    just before it and read just after."""
    import concurrent.futures
    import multiprocessing

    import numpy as np
    import torch
    from repro_torch.clustering import dtcr, kmeans, metrics
    from repro_torch.configs.tnn_columns import column_config

    names = list(ucr.PAPER_COLUMNS)
    t_phase = time.perf_counter()
    data = {}
    for name in names:
        ds = ucr.load(name)
        data[name] = (ds.x[:TABLE2_N], ds.y[:TABLE2_N], ds.n_classes)
    rows = {name: {} for name in names}
    for k in build.KERNELS:
        k.launches = 0

    # k-means and the TNN column, card against CPU
    for name in names:
        x, y, k = data[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, km = kmeans.kmeans(x, k, seed=0, device=dev)
        km_s = time.perf_counter() - t0
        _, km_cpu = kmeans.kmeans(x, k, seed=0, device="cpu")
        assert np.array_equal(km, km_cpu), f"{name}: k-means labels differ"
        cfg = column_config(name)
        cfg = cfg.with_threshold(simulator.suggest_threshold(cfg))
        w0 = column.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        kw = dict(epochs=TABLE2_EPOCHS, mode="pallas", seed=0, params=w0)
        before = {kk.name: kk.launches for kk in build.KERNELS}
        tnn = simulator.cluster_time_series(x, y, cfg, device="cuda", **kw)
        grew = {kk.name: kk.launches - before[kk.name] for kk in build.KERNELS}
        tnn_cpu = simulator.cluster_time_series(x, y, cfg, device="cpu", **kw)
        assert tnn.lowering == "cuda" and grew["fused_step"] == 1, grew
        assert np.array_equal(tnn.assignments, tnn_cpu.assignments), name
        assert tnn.rand_index == tnn_cpu.rand_index
        rows[name].update(ri_kmeans=metrics.rand_index(y, km), kmeans_s=km_s,
                          ri_tnn=tnn.rand_index, train_seconds=tnn.train_seconds)
        log(f"[table2] {name} N={x.shape[0]} L={x.shape[1]} k={k}: k-means "
            f"labels card == CPU, {km_s!r} s; TNN {cfg.p}x{cfg.q} ids card == "
            f"CPU, train_seconds={tnn.train_seconds!r} launches={grew}")

    # DTCR: one step card against CPU from the same parameters, TF32 off,
    # which also gives each design's seconds a step on the card
    cfgs, params, est = {}, {}, {}
    for name in names:
        x, _, k = data[name]
        cfgs[name] = dtcr.DTCRConfig(n_clusters=k, steps=DTCR_STEPS)
        params[name] = dtcr.init_params(torch.Generator().manual_seed(0),
                                        cfgs[name], "cpu")
        out = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            p = dtcr._tree_map(lambda t: t.to(d), params[name])
            xt = dtcr.normalize(torch.as_tensor(x, dtype=torch.float32, device=d))
            c = dtcr.initial_centers(cfgs[name], d)
            loss, g = dtcr.value_and_grad(p, xt, c, cfgs[name])
            out[where] = (float(loss), np.concatenate(
                [a.ravel() for a in dtcr._leaves(dtcr.params_to_numpy(g))]))
            if where == "card":  # two warm steps: seconds a step
                m = v = dtcr._tree_map(torch.zeros_like, p)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for t in (1, 2):
                    _, g = dtcr.value_and_grad(p, xt, c, cfgs[name])
                    with torch.no_grad():
                        p, m, v = dtcr.adam_step(p, m, v, g, t, cfgs[name].lr)
                torch.cuda.synchronize()
                est[name] = (time.perf_counter() - t0) / 2
        dl = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        dg = float(np.abs(out["card"][1] - out["cpu"][1]).max()
                   / np.abs(out["cpu"][1]).max())
        log(f"[table2] {name} DTCR one step card vs CPU: loss {out['card'][0]!r} "
            f"vs {out['cpu'][0]!r} (rel {dl!r}), gradients rel to the largest "
            f"{dg!r}; {est[name]!r} s a step on the card")
        assert dl <= 1e-4 and dg <= 1e-4, (name, dl, dg)

    # where a step's time goes: one step on the shortest series under
    # torch.profiler (the longest, ~10^5 kernels a step, takes minutes to
    # tabulate)
    from torch.profiler import ProfilerActivity, profile

    for name in (min(names, key=lambda n: data[n][0].shape[1]),):
        x = data[name][0]
        p = dtcr._tree_map(lambda t: t.to(dev), params[name])
        m = v = dtcr._tree_map(torch.zeros_like, p)
        xt = dtcr.normalize(torch.as_tensor(x, dtype=torch.float32, device=dev))
        c = dtcr.initial_centers(cfgs[name], dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, g = dtcr.value_and_grad(p, xt, c, cfgs[name])
            with torch.no_grad():
                dtcr.adam_step(p, m, v, g, 1, cfgs[name].lr)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, n_k = device_us(prof)
        log(f"[profile] DTCR step {name} (N={x.shape[0]}, L={x.shape[1]}) wall "
            f"{wall!r} ms (profiled); device busy {busy / 1e3!r} ms in {n_k} "
            f"kernels; device idle share {1 - busy / 1e3 / wall!r} | {card}")

    log(f"[table2] k-means, TNN, DTCR one-step checks and profile in "
        f"{time.perf_counter() - t_phase:.1f} s")
    steps = dtcr_steps(est)
    for name in names:
        if steps[name] < DTCR_STEPS:
            log(f"[table2] cut: {name} DTCR at {steps[name]} of {DTCR_STEPS} "
                f"steps (est. {est[name]!r} s a step; {DTCR_BUDGET_S} s for all seven)")
    jobs = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(DTCR_WORKERS, mp_context=ctx) as ex:
        for name in sorted(names, key=lambda n: -est[n] * steps[n]):
            x, _, k = data[name]
            jobs[name] = ex.submit(dtcr_cpu_labels, (
                x, dict(n_clusters=k, steps=steps[name]),
                dtcr.params_to_numpy(params[name])))
        for name in names:
            x, y, k = data[name]
            cfg = dtcr.DTCRConfig(n_clusters=k, steps=steps[name])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels = dtcr.fit_predict(x, cfg, device=dev, params=params[name])
            fit_s = time.perf_counter() - t0
            rows[name].update(ri_dtcr=metrics.rand_index(y, labels),
                              dtcr_steps=steps[name],
                              dtcr_s_step=fit_s / steps[name], labels=labels)
        t_fits = time.perf_counter()
        log(f"[table2] DTCR fits on the card in {t_fits - t_phase:.1f} s of the phase")
        for name in names:
            cpu_labels, cpu_s = jobs[name].result()
            r = rows[name]
            r["dtcr_card_cpu_ri"] = metrics.rand_index(cpu_labels, r.pop("labels"))
            r["dtcr_cpu_s_step"] = cpu_s / steps[name]
    launches = {k.name: k.launches for k in build.KERNELS}
    log(f"[table2] waited {time.perf_counter() - t_fits:.1f} s for the CPU's "
        f"DTCR fits; phase 20 in {time.perf_counter() - t_phase:.1f} s")

    log("[table2] | design | RI k-means | RI TNN | RI DTCR | TNN norm (paper) | "
        "DTCR norm (paper) | TNN train_seconds | k-means s | DTCR steps | "
        "DTCR s/step card (CPU) | DTCR labels card vs CPU RI |")
    for name in names:
        r, paper = rows[name], ucr.PAPER_RAND_INDEX[name]
        r["tnn_norm"] = metrics.normalized_rand(r["ri_tnn"], r["ri_kmeans"])
        r["dtcr_norm"] = metrics.normalized_rand(r["ri_dtcr"], r["ri_kmeans"])
        log(f"[table2] | {name} | {r['ri_kmeans']!r} | {r['ri_tnn']!r} | "
            f"{r['ri_dtcr']!r} | {r['tnn_norm']!r} ({paper['tnn']}) | "
            f"{r['dtcr_norm']!r} ({paper['dtcr']}) | {r['train_seconds']!r} | "
            f"{r['kmeans_s']!r} | {r['dtcr_steps']} | {r['dtcr_s_step']!r} "
            f"({r['dtcr_cpu_s_step']!r}) | {r['dtcr_card_cpu_ri']!r} |")
        for key in ("ri_kmeans", "ri_tnn", "ri_dtcr"):
            assert 0.0 <= r[key] <= 1.0, (name, key, r[key])
    log(f"[table2] launches={launches} | {card}")
    assert launches["fused_step"] == len(names) and launches["rnl_fire"] >= len(names)
    assert all(v == 0 for n, v in launches.items()
               if n not in ("fused_step", "rnl_fire")), launches


def lm_serving(T, serve_lib, cfg, build, dev, card, n_prefill=None, n_decode=0,
               tag="serve", n_ssd=0) -> dict:
    """The serving path at full width (phase 16: granite-3-8b at full
    depth; phase 22: each family), launch counters reset just before it
    and read just after: ``n_prefill`` flash launches a prefill (default
    one a layer) and ``n_decode`` a decode step, ``n_ssd`` SSD scan
    launches and as many causal conv launches a prefill (one each a mamba
    layer; none a decode step) and 2 ``n_ssd`` decode-step kernel launches
    a decode step (``ssm_step``), nothing else; then again,
    warm; then one prefill and four decode steps profiled.  Returns its
    numbers."""
    import torch

    n_prefill = cfg.n_layers if n_prefill is None else n_prefill
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    for k in build.KERNELS:
        k.launches = 0
    r = serve_lib.serve(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT, tokens=LM_TOKENS,
                        device=dev, model=model)
    launches = {k.name: k.launches for k in build.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(r.prefill_logits).all()) and bool(
        torch.isfinite(r.last_logits).all())
    want = n_prefill + (LM_TOKENS - 1) * n_decode
    log(f"[{tag}] {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} {cfg.dtype} "
        f"({n_params} parameters): prefill[{LM_BATCH}x{LM_PROMPT}] "
        f"{r.prefill_s * 1e3!r} ms, {LM_TOKENS} tokens, decode "
        f"{r.decode_s_per_token * 1e3!r} ms/token; launches={launches} (flash: "
        f"{n_prefill} a prefill + {LM_TOKENS - 1} x {n_decode} a decode step; "
        f"ssd_scan and causal_conv: {n_ssd} a prefill each; ssm_step: 2 x {n_ssd} a "
        f"decode step); peak "
        f"device memory {peak} B; logits finite={finite} | {card}")
    log(f"[{tag}] sample generations: {r.generations[:2, :8].tolist()}")
    assert launches == {k.name: 0 for k in build.KERNELS} | {
        "flash_attention": want, "ssd_scan": n_ssd, "causal_conv": n_ssd,
        "ssm_step": (LM_TOKENS - 1) * 2 * n_ssd}, (cfg.name, launches, want, n_ssd)
    assert finite and r.generations.shape == (LM_BATCH, LM_TOKENS)
    assert r.prefill_logits.shape == (LM_BATCH, LM_PROMPT, cfg.vocab_padded)
    assert int(r.generations.max()) < cfg.vocab_size
    out = dict(launches=launches["flash_attention"], ssd_launches=launches["ssd_scan"],
               conv_launches=launches["causal_conv"], step_launches=launches["ssm_step"],
               peak=peak, params=n_params,
               prefill_ms=r.prefill_s * 1e3, decode_ms=r.decode_s_per_token * 1e3)
    del r
    warm = serve_lib.serve(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT,
                           tokens=LM_TOKENS, device=dev, model=model)
    log(f"[{tag}] {cfg.name} warm: prefill[{LM_BATCH}x{LM_PROMPT}] "
        f"{warm.prefill_s * 1e3!r} ms, decode {warm.decode_s_per_token * 1e3!r} "
        f"ms/token | {card}")
    del warm
    frames = None
    if cfg.family == "audio":  # the launcher's default frames
        frames = torch.zeros((LM_BATCH, cfg.enc_seq, cfg.d_model),
                             dtype=model.embed.dtype, device=dev)
    out["profile"] = profile_serving(T, model, cfg, dev, card, frames=frames,
                                     label="" if tag == "serve" else f"{cfg.name} ")
    return out


def device_us(prof, match=None) -> tuple[float, int]:
    """Device time (us) and count of the kernels in a ``torch.profiler``
    run, all of them or those whose name contains ``match``."""
    import torch

    total, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and (
                match is None or match in e.key):
            total += e.self_device_time_total
            n += e.count
    return total, n


def top_kernels(prof, n: int = 4) -> str:
    """The ``n`` kernels of a ``torch.profiler`` run with the most device
    time: name (cut to 60 characters), ms, launches."""
    import torch

    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)[:n]
    return "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3!r} ms in {e.count}"
                     for e in rows)


def profile_serving(T, model, cfg, dev, card, frames=None, label="") -> dict:
    """Where the serving time goes: one prefill and four decode steps
    under ``torch.profiler``, device time summed by kernel (the flash
    kernel apart) against the host clock of the same, profiled, run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen,
                            device=dev)
    out = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cache, logits = T.prefill(model, prompts, max_len=LM_PROMPT + 8,
                                      frames=frames)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, n = device_us(prof)
        flash, n_flash = device_us(prof, "flash_kernel")
        out["prefill"] = (wall, busy / 1e3, n, flash / 1e3, n_flash)
        log(f"[profile] {label}prefill[{LM_BATCH}x{LM_PROMPT}] wall {wall!r} ms (profiled); "
            f"device busy {busy / 1e3!r} ms in {n} kernels, of which flash_kernel "
            f"{flash / 1e3!r} ms in {n_flash}; device idle share "
            f"{1 - busy / 1e3 / wall!r} | {card}")
        log(f"[profile] {label}prefill, top kernels by device time: {top_kernels(prof)}")
        tok = torch.argmax(logits[:, -1:, : cfg.vocab_size], dim=-1)
        del logits
        steps = 4
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                cache, lg = T.decode_step(model, cache, tok)
                tok = torch.argmax(lg[:, -1:, : cfg.vocab_size], dim=-1)
                tok.cpu()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        busy, n = device_us(prof)
        out["decode"] = (wall, busy / 1e3 / steps, n / steps)
        log(f"[profile] {label}decode step (B={LM_BATCH}) wall {wall!r} ms (profiled); device "
            f"busy {busy / 1e3 / steps!r} ms in {n / steps} kernels a step; device "
            f"idle share {1 - busy / 1e3 / steps / wall!r} | {card}")
    return out


def flash_bound(b, sq, hq, hkv, d, elem_bytes, split: bool = False,
                skv=None, causal: bool = True) -> tuple[int, int]:
    """Bytes and operations of one flash launch (causal: Sq = Skv): Q, K,
    V read and O written once; QK and PV over the causal triangle (every
    pair where not causal), 2 d operations per (query, key) pair each,
    and PV twice where P is split into two bf16 parts (the bf16 kernel)."""
    skv = sq if skv is None else skv
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    n_bytes = elem_bytes * (2 * b * sq * hq * d + 2 * b * skv * hkv * d)
    n_ops = (6 if split else 4) * d * pairs * b * hq
    return n_bytes, n_ops


def time_device_layout(fused_column, rnl_response, timer, dev, card) -> dict:
    """The four fire kernels at 650 x 130, where each takes its
    device-memory layout: ms, plain ms, bound ms and what bounds it.
    ``rnl_fire`` and ``fire_block`` on int32 times (bound by the slope
    form's operations) and on the same times as f32 (the ramp sum's)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(650)
    p, q, n_b = 650, 130, 121
    w_d = torch.from_numpy(half_grid(rng, (2, p, q))).to(dev)
    blk_d = torch.from_numpy(rng.integers(0, 72, (2, 32, p)).astype(np.float32)).to(dev)
    xs_d = torch.from_numpy(rng.integers(0, 72, (2, n_b, p)).astype(np.int32)).to(dev)
    xs_f = xs_d.to(torch.float32)
    ops_d = fused_column.design_operands([0.25 * p * 3.5] * 2, [64, 64], [q, q],
                                         0.5, 0.5, 1 / 1024, device=dev)
    kw_d = dict(t_window=64, w_max=7, wta_k=1, stabilize=True)
    fkw = dict(t_window=64, w_max=7)
    thr = 0.25 * p * 3.5
    w1, ops1 = w_d[:1].contiguous(), ops_d[:1]
    x1 = blk_d[:1, 0].to(torch.int32).contiguous()
    x1f = x1.to(torch.float32)
    one_bytes, one_slope, one_ramp = fit_bound(
        fused_column, w1, x1[:, None], ops1, dict(kw_d, epochs=1), last=True)
    r_bytes, r_slope, r_ramp = rnl_bound(rnl_response, xs_d[0], w_d[0], thr, 64, 7)
    g_bytes, g_slope, g_ramp = fire_bound(fused_column, w_d, xs_d, ops_d, fkw)
    # (name, shape, kernel, plain version, (bytes, operations), reps)
    cases = (
        ("fused_step", "D=1 one volley, int32 times",
         lambda: fused_column.fused_step_padded(w1, x1, ops1, **kw_d),
         lambda: fused_column.fused_step_padded_plain(w1, x1, ops1, **kw_d),
         (one_bytes, one_slope), 200),
        ("fused_step f32", "D=1 one volley, f32 times",
         lambda: fused_column.fused_step_padded(w1, x1f, ops1, **kw_d),
         lambda: fused_column.fused_step_padded_plain(w1, x1f, ops1, **kw_d),
         (one_bytes, one_ramp), 200),
        ("rnl_fire", f"B={n_b}, int32 times",
         lambda: rnl_response.rnl_fire(xs_d[0], w_d[0], thr, 64, 7),
         lambda: rnl_response.rnl_fire_plain(xs_d[0], w_d[0], thr, 64, 7),
         (r_bytes, r_slope), 20),
        ("rnl_fire f32", f"B={n_b}, f32 times",
         lambda: rnl_response.rnl_fire(xs_f[0], w_d[0], thr, 64, 7),
         lambda: rnl_response.rnl_fire_plain(xs_f[0], w_d[0], thr, 64, 7),
         (r_bytes, r_ramp), 20),
        ("fused_block", "D=2 v_blk=32",
         lambda: fused_column.fused_block_padded(w_d, blk_d, ops_d, 32, **kw_d),
         lambda: fused_column.fused_block_padded_plain(w_d, blk_d, ops_d, 32, **kw_d),
         block_bound(fused_column, w_d, blk_d, ops_d, kw_d)[:2], 5),
        ("fire_block", f"D=2 N={n_b}, int32 times",
         lambda: fused_column.fire_block_padded(w_d, xs_d, ops_d, **fkw),
         lambda: fused_column.fire_block_padded_plain(w_d, xs_d, ops_d, **fkw),
         (g_bytes, g_slope), 20),
        ("fire_block f32", f"D=2 N={n_b}, f32 times",
         lambda: fused_column.fire_block_padded(w_d, xs_f, ops_d, **fkw),
         lambda: fused_column.fire_block_padded_plain(w_d, xs_f, ops_d, **fkw),
         (g_bytes, g_ramp), 20),
    )
    # both bounds of the two fire kernels, whichever form their times take
    both = {"rnl_fire": (r_slope, r_ramp), "fire_block": (g_slope, g_ramp)}
    out = {}
    for name, shape, kern, plain, (n_bytes, n_ops), reps in cases:
        ms = timer(kern, reps)
        plain_ms = timer(plain, 2, warmup=1)
        b_ms, by = bound_ms(n_bytes, n_ops)
        out[name] = (ms, plain_ms, b_ms, by)
        two = both.get(name.split()[0])
        forms = "" if two is None else (
            f"; the slope form's {two[0]} ops, {bound_ms(n_bytes, two[0])[0]!r} ms; "
            f"the ramp sum's {two[1]} ops, {bound_ms(n_bytes, two[1])[0]!r} ms")
        log(f"[time] device-memory layout {name} {p}x{q} {shape} ms={ms!r} "
            f"plain_ms={plain_ms!r} bound_ms={b_ms!r} ({by}; {n_bytes} B, "
            f"{n_ops} ops{forms}) | {card}")
    return out


# (label, B, Sq, Skv, Hq, Hkv, d, causal): one flash launch of each LM
# path, granite-3-8b's prefill layer first (the kernels line's row)
FLASH_TIMED = (
    ("granite-3-8b prefill layer", LM_BATCH, LM_PROMPT, LM_PROMPT, 32, 8, 128, True),
    ("kimi-k2 prefill layer", LM_BATCH, LM_PROMPT, LM_PROMPT, 64, 8, 112, True),
    ("zamba2 prefill layer", LM_BATCH, LM_PROMPT, LM_PROMPT, 32, 32, 112, True),
    ("whisper encoder layer", LM_BATCH, 1500, 1500, 16, 16, 64, False),
    ("whisper decode cross-attention", LM_BATCH, 1, 1500, 16, 16, 64, False),
)


def time_flash(flash_lib, timer, dev, card) -> dict:
    """The flash kernel (bf16) at each LM path's shape: held per element
    against the plain version in f32 on the same values (one bf16
    rounding plus 1e-5 of the largest output), then timed beside the
    plain version, PyTorch's fused attention (timed here, never called by
    the port) and the bound of its split-P products.  Returns (ms, plain
    ms, bound ms, what bounds it, library ms) by label."""
    import torch
    import torch.nn.functional as F

    out = {}
    for label, b, sq, skv, hq, hkv, d, causal in FLASH_TIMED:
        q, k, v = flash_inputs(b, sq, hq, hkv, d, torch.bfloat16, dev, skv=skv)
        got = flash_lib.flash_attention(q, k, v, causal)
        ref32 = flash_lib.flash_attention_plain(q.float(), k.float(), v.float(), causal)
        bound = 2.0 ** -8 * ref32.abs() + 1e-5 * ref32.abs().max()
        ratio = float(((got.float() - ref32).abs() / bound).max())
        del ref32, bound
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, d] views

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)

        ms = timer(lambda: flash_lib.flash_attention(q, k, v, causal), 20)
        plain_ms = timer(lambda: flash_lib.flash_attention_plain(q, k, v, causal), 3,
                         warmup=1)
        lib_ms = timer(sdpa, 20)
        err = rel_err(sdpa().transpose(1, 2), got)
        n_bytes, n_ops = flash_bound(b, sq, hq, hkv, d, 2, split=True, skv=skv,
                                     causal=causal)
        b_ms, by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
        two = flash_bound(b, sq, hq, hkv, d, 2, skv=skv, causal=causal)[1]
        out[label] = (ms, plain_ms, b_ms, by, lib_ms)
        log(f"[time] flash_attention {label}: B={b} Sq={sq} Skv={skv} Hq={hq} "
            f"Hkv={hkv} d={d} bf16 causal={causal} ms={ms!r} plain_ms={plain_ms!r} "
            f"sdpa_ms={lib_ms!r} bound_ms={b_ms!r} ({by}; {n_bytes} B, {n_ops} ops "
            f"of the split-P products at the bf16 peak; the two products alone "
            f"{two} ops, {two / BF16_OPS_PER_S * 1e3!r} ms); SDPA against the "
            f"kernel, relative to the largest: {err}; per element against f32, "
            f"largest |d| / (u|ref| + 1e-5 max|ref|)={ratio} (<= 1) | {card}")
        assert ratio <= 1, ("flash_attention differs per element", label, ratio)
        del q, k, v, qt, kt, vt, got
    return out


# phase 17: MLA's expanded prefill at the kanana-2-30b-a3b-instruct.longdoc32k
# cell's shape, one launch a layer and prompt row: (B, S, heads, Q and K's
# head dim, V's), causal, scale 192^-1/2
MLA_TIMED = (1, 32704, 32, 192, 128)


def time_flash_mla(flash_lib, timer, dev, card) -> tuple:
    """The flash kernel's 192 / 128 instantiation (bf16,
    ``tc::flash_mla_kernel<192, 128>``) at the cell's prefill row: held per
    element against the plain version in f32 on the same values (one bf16
    rounding plus 1e-5 of the largest output), then timed beside the plain
    version; the bound counts 2 (192 + 128) a causal pair a head (the
    split P's second P·V uncounted).  Returns (ms, plain ms, bound ms,
    what bounds it)."""
    import torch

    b, s, h, dqk, dv = MLA_TIMED
    g = torch.Generator(device=dev).manual_seed(33)
    q, k = (torch.randn((b, s, h, dqk), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=g, device=dev).to(torch.bfloat16)
    got = flash_lib.flash_attention(q, k, v, True)
    ref32 = flash_lib.flash_attention_plain(q.float(), k.float(), v.float(), True)
    bound = 2.0 ** -8 * ref32.abs() + 1e-5 * ref32.abs().max()
    ratio = float(((got.float() - ref32).abs() / bound).max())
    del ref32, bound, got
    ms = timer(lambda: flash_lib.flash_attention(q, k, v, True), 5)
    plain_ms = timer(lambda: flash_lib.flash_attention_plain(q, k, v, True), 1, warmup=1)
    pairs = s * (s + 1) // 2
    n_ops = (2 * dqk + 2 * dv) * pairs * b * h
    n_bytes = 2 * b * h * s * (2 * dqk + 2 * dv)
    b_ms, by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    log(f"[time] flash_attention MLA prefill row: B={b} S={s} H={h} d={dqk}/{dv} bf16 "
        f"causal ms={ms!r} plain_ms={plain_ms!r} bound_ms={b_ms!r} ({by}; {n_bytes} B, "
        f"{n_ops} ops); per element against f32, largest |d| / (u|ref| + 1e-5 "
        f"max|ref|)={ratio} (<= 1) | {card}")
    assert ratio <= 1, ("flash_attention differs per element at MLA's dims", ratio)
    del q, k, v
    return ms, plain_ms, b_ms, by


# phase 17: the SSD scan at the zamba2-7b-instruct.docs4k cell's prefill
# shape (b, L, H, G, N, dh, chunk): B 8 x 4,032, chunks of 256; and at the
# granite-4.0-h-small.rag2k cell's: B 8 x 1,920, N 128 (the (128, 64, 256)
# tile, C read from device memory)
SSD_TIMED = (8, 4032, 112, 2, 64, 64, 256)
SSD_TIMED_RAG2K = (8, 1920, 128, 1, 128, 64, 256)


def ssd_bound(b, L, H, G, N, dh, chunk, elem_bytes) -> tuple[int, int]:
    """Bytes and operations of one scan from a zero state: x, B and C
    (``elem_bytes`` each) and dt (f32) read once, y and the final state
    written once in f32; the dual form's 2 (N + dh) operations a causal
    (query, key) pair of a chunk (C B^T, then mask * scores times x) and
    the state's 4 N dh a position (B^T x and C S), as the plain version
    does them (the kernel's bf16 parts do more)."""
    full, last = divmod(L, chunk)
    pairs = full * chunk * (chunk + 1) // 2 + last * (last + 1) // 2
    n_bytes = (elem_bytes * b * L * (H * dh + 2 * G * N) + 4 * b * L * H
               + 4 * b * L * H * dh + 4 * b * H * N * dh)
    n_ops = b * H * (2 * (N + dh) * pairs + 4 * N * dh * L)
    return n_bytes, n_ops


def time_ssd(timer, dev, card, shape=SSD_TIMED, label="zamba2-7b-instruct") -> tuple:
    """The SSD scan kernel (bf16) at ``shape`` through ``ssd_chunked``:
    held to the plain version (``repro_torch.testing.ssd``: per element
    and in the norm, bit-equality printed), then timed beside it and its
    bound.  Returns ((ms, plain ms, bound ms, what bounds it), the largest
    |difference| of y)."""
    import torch

    from repro_torch.models import ssm
    from repro_torch.testing import ssd as ssd_test

    b, L, H, G, N, dh, chunk = shape
    bf = torch.bfloat16
    ops = ssd_test.ssd_inputs(b, L, H, G, N, dh, bf, dev, seed=L, initial=False)
    r = ssd_test.agreement(ssm.ssd_chunked(**ops, chunk=chunk, compute_dtype=bf), ops,
                           chunk)
    ms = timer(lambda: ssm.ssd_chunked(**ops, chunk=chunk, compute_dtype=bf), 20)
    plain_ms = timer(lambda: ssm.ssd_chunked_plain(**ops, chunk=chunk, compute_dtype=bf),
                     3, warmup=1)
    n_bytes, n_ops = ssd_bound(b, L, H, G, N, dh, chunk, 2)
    b_ms, by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    log(f"[time] ssd_scan {label} prefill layer: B={b} L={L} H={H} G={G} "
        f"N={N} dh={dh} chunk={chunk} bf16 ms={ms!r} plain_ms={plain_ms!r} "
        f"bound_ms={b_ms!r} ({by}; {n_bytes} B, {n_ops} ops; the operations alone "
        f"{n_ops / BF16_OPS_PER_S * 1e3!r} ms at the bf16 peak); against the plain "
        f"version: {r} (y, state, norm <= 1) | {card}")
    assert ssd_test.holds(r), ("ssd_scan differs", r)
    return (ms, plain_ms, b_ms, by), r["max_abs"]


# phase 17: the causal conv at the same prefill's shape (b, L, d_inner,
# G * N, SSD heads): C = 7,424 channels of 14,704-wide in_proj rows
CONV_TIMED = (8, 4032, 7168, 128, 112)


def time_conv(timer, dev, card) -> tuple:
    """The causal conv kernel (bf16) at ``CONV_TIMED`` through
    ``_causal_conv``, on the in_proj output's x | B | C columns with a
    bias, from no state (the no-cache forward) and from a state (a cached
    prefill): bit-equal to the plain version, then timed beside it and its
    bound (bytes: u read once, out written once).  Returns (ms, plain ms,
    bound ms, what bounds it)."""
    import torch

    from repro_torch.models import ssm

    b, L, di, gn, heads = CONV_TIMED
    c = di + 2 * gn
    g = torch.Generator(device=dev).manual_seed(L)
    bf = torch.bfloat16
    proj = torch.randn((b, L, di + c + heads), generator=g, device=dev).to(bf)
    u = proj[..., di: di + c]
    w = (torch.randn((4, c), generator=g, device=dev) * 0.5).to(bf)
    bias = torch.randn((c,), generator=g, device=dev).to(bf)
    state = torch.randn((b, 3, c), generator=g, device=dev).to(bf)
    n_bytes = 2 * b * L * c * 2
    b_ms, by = bound_ms(n_bytes, 0)
    for st in (None, state):
        got = ssm._causal_conv(u, w, st, bias)
        want = ssm._causal_conv_plain(u, w, st, bias)
        equal = all(torch.equal(x.view(torch.int16), y.contiguous().view(torch.int16))
                    for x, y in zip(got, want))
        del got, want
        ms = timer(lambda: ssm._causal_conv(u, w, st, bias), 50)
        plain_ms = timer(lambda: ssm._causal_conv_plain(u, w, st, bias), 5, warmup=1)
        log(f"[time] causal_conv zamba2-7b-instruct prefill layer: B={b} L={L} C={c} "
            f"bf16, bias, state={st is not None} ms={ms!r} plain_ms={plain_ms!r} "
            f"bound_ms={b_ms!r} ({by}; {n_bytes} B); bit-equal to the plain version "
            f"(out, new state): {equal} | {card}")
        assert equal, "causal_conv differs from its plain version"
    return ms, plain_ms, b_ms, by


# phase 17: a mamba layer's decode step at the two LM cells' widths, B 8:
# zamba2-7b-instruct.docs4k's (G 2, N 64, H 112) and
# granite-4.0-h-small.rag2k's (G 1, N 128, H 128)
STEP_TIMED = ("zamba2-7b-instruct", "granite-4.0-h-small")
STEP_BATCH = 8


def step_bound(cfg, b: int, elem_bytes: int) -> int:
    """Bytes of one decode step of a mamba layer up to out_proj's input: S
    read and the new S written (f32); the window (the conv state's three
    rows and the token's x | B | C), z and dt read, the new conv state and
    y written; the taps, the bias, gamma and the three f32 vectors read
    once."""
    H, G, N, dh = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    di = H * dh
    c = di + 2 * G * N
    return (2 * 4 * b * H * N * dh + elem_bytes * b * (4 * c + di + H)
            + elem_bytes * b * (3 * c + di) + elem_bytes * (5 * c + di) + 3 * 4 * H)


def time_ssm_step(timer, dev, card, get_arch) -> dict:
    """The decode step's kernels (bf16) at each ``STEP_TIMED`` cell's widths,
    B 8: held to the plain version (``repro_torch.testing.ssm_step``: the
    states bit-equal, y within its bound), then timed: the two launches
    alone beside their bytes bound, ``_one_token`` and ``_one_token_plain``
    with the cell's out_proj, and that out_proj product alone.  Returns
    {arch: (ms, plain ms, bound ms, what bounds it, _one_token ms, out_proj
    ms, the largest |difference| of y)}."""
    import torch

    from repro_torch.kernels import ssm_step as step_lib
    from repro_torch.models import ssm
    from repro_torch.testing import ssm_step as step_test

    bf = torch.bfloat16
    out = {}
    for arch in STEP_TIMED:
        cfg = get_arch(arch)
        p, proj, cache = step_test.step_inputs(cfg, STEP_BATCH, bf, dev, seed=cfg.ssm_heads)
        r = step_test.agreement(ssm._one_token(p, proj, cfg, cache),
                                ssm._one_token_plain(p, proj, cfg, cache), p, proj, cfg, cache)
        p["out_proj"] = (torch.randn((cfg.d_inner, cfg.d_model), device=dev) * 0.02).to(bf)
        args = (proj, cache["conv"], cache["S"], p["conv_w"], p.get("conv_b"), p["dt_bias"],
                p["A_log"], p["D_skip"], p["norm"])
        kw = dict(groups=cfg.ssm_groups, dt_min=cfg.dt_min, norm=cfg.ssm_norm,
                  eps=cfg.norm_eps if cfg.ssm_norm == "grouped" else ssm.RMSNORM_EPS)
        y = step_lib.ssm_step(*args, **kw)[0]
        ms = timer(lambda: step_lib.ssm_step(*args, **kw), 200)
        token_ms = timer(lambda: ssm._one_token(p, proj, cfg, cache), 200)
        plain_ms = timer(lambda: ssm._one_token_plain(p, proj, cfg, cache), 50)
        proj_ms = timer(lambda: y @ p["out_proj"], 200)
        n_bytes = step_bound(cfg, STEP_BATCH, 2)
        b_ms, by = bound_ms(n_bytes, 0)
        log(f"[time] ssm_step {arch} decode layer: B={STEP_BATCH} H={cfg.ssm_heads} "
            f"G={cfg.ssm_groups} N={cfg.ssm_state} dh={cfg.ssm_head_dim} bf16 ms={ms!r} "
            f"(the two launches) bound_ms={b_ms!r} ({by}; {n_bytes} B); _one_token "
            f"ms={token_ms!r}, _one_token_plain ms={plain_ms!r}, both with out_proj "
            f"[{cfg.d_inner}, {cfg.d_model}] alone ms={proj_ms!r}; against the plain "
            f"version: {r} (states equal, y ratio <= 1) | {card}")
        assert step_test.holds(r), ("ssm_step differs", arch, r)
        out[arch] = (ms, plain_ms, b_ms, by, token_ms, proj_ms, r["max_abs"])
        del p, proj, cache, y
    return out


def family_check(T, moe_lib, cfg_full, dev, card) -> None:
    """Phase 22, card against CPU: full width, depth cut to one attention
    application, f32; card logits against a float64 CPU reference of the
    same weights, prefill then 4 decode steps (MoE: the router ids of
    every call first); then serve-matches-forward on the card model."""
    import dataclasses

    import torch

    layers = FAMILY_CHECK_LAYERS.get(cfg_full.name, 2)
    kw = dict(n_layers=layers, dtype="float32")
    cuts = [f"{layers} of {cfg_full.n_layers} layers"]
    if cfg_full.family == "audio":
        kw["enc_layers"] = 2
        cuts.append(f"2 of {cfg_full.enc_layers} encoder layers")
    if cfg_full.name == "kimi-k2-1t-a32b":
        kw["n_experts"] = KIMI_CHECK_EXPERTS
        cuts.append(f"{KIMI_CHECK_EXPERTS} of {cfg_full.n_experts} experts (card and CPU)")
    cfg = dataclasses.replace(cfg_full, **kw)
    t0 = time.perf_counter()
    card_m = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(5),
                           device=dev)
    ref_m = T.Transformer(T.weights(card_m, lambda t: t.to("cpu", torch.float64)), cfg)
    g = torch.Generator().manual_seed(6)
    s = FAMILY_CHECK_PROMPT
    toks = torch.randint(0, cfg.vocab_size, (2, s + 4), generator=g)
    frames = (torch.randn((2, cfg.enc_seq, cfg.d_model), generator=g)
              if cfg.family == "audio" else None)
    runs = (("card", card_m, dev, None if frames is None else frames.to(dev)),
            ("cpu", ref_m, "cpu", None if frames is None else frames.double()))
    ids = {"card": [], "cpu": []}
    route = moe_lib.router_topk
    side = ["card"]

    def recording(x, router, top_k):
        probs, got, aux = route(x, router, top_k)
        ids[side[0]].append(got.cpu())
        return probs, got, aux

    moe_lib.router_topk = recording
    steps = {"card": [], "cpu": []}
    try:
        with torch.inference_mode():
            for name, m, d, fr in runs:
                side[0] = name
                c, lg = T.prefill(m, toks[:, :s].to(d), max_len=s + 6, frames=fr)
                steps[name].append(lg)
                for t in range(s, s + 4):
                    c, lg = T.decode_step(m, c, toks[:, t : t + 1].to(d))
                    steps[name].append(lg)
                del c
    finally:
        moe_lib.router_topk = route
    if cfg.family == "moe":
        same = [bool(torch.equal(a, b)) for a, b in zip(ids["card"], ids["cpu"])]
        log(f"[families] {cfg.name} router ids card vs CPU, each MoE call (layer x "
            f"step): {sum(same)} of {len(same)} equal; "
            f"{sum(int(a.numel()) for a in ids['cpu'])} assignments; the last "
            f"call's first token: card {ids['card'][-1][0].tolist()}, CPU "
            f"{ids['cpu'][-1][0].tolist()}")
        assert len(same) == 5 * layers and all(same), same
    logits = list(zip(steps["card"], steps["cpu"]))
    errs = [rel_err(c, r) for c, r in logits]
    log(f"[families] {cfg.name} full width, cut to {', '.join(cuts)}, f32: card "
        f"logits vs the float64 CPU reference, relative to the largest, "
        f"prefill({s}) then 4 decode steps: {errs} (< 1e-4; "
        f"{time.perf_counter() - t0:.1f}s)")
    assert max(errs) < 1e-4, (cfg.name, errs)
    assert all(bool(torch.isfinite(c).all()) for c, _ in logits)
    if cfg.mrope:
        # three distinct seeded position streams, so each M-RoPE section
        # reads its own stream (the default positions are equal on all three)
        pos = torch.randint(0, 4 * s, (3, 2, s), generator=g)
        with torch.inference_mode():
            got = T.forward(card_m, toks[:, :s].to(dev), positions=pos.to(dev))
            want = T.forward(ref_m, toks[:, :s], positions=pos)
        err = rel_err(got, want)
        log(f"[families] {cfg.name} forward on three distinct M-RoPE position "
            f"streams, card vs the float64 CPU reference, relative to the largest: "
            f"{err} (< 1e-4)")
        assert err < 1e-4 and bool(torch.isfinite(got).all()), (cfg.name, err)
        del got, want
    del ref_m, steps, logits
    # the JAX package's test_serve_matches_forward: B 2, 12 tokens, f32
    toks = torch.randint(0, cfg.vocab_size, (2, 12), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(8))
    fr = None if frames is None else frames.to(dev)
    err, _ = serve_vs_forward(T, card_m, toks, fr)
    held = cfg.family != "moe"
    log(f"[families] {cfg.name} serve vs forward logits relative to the largest "
        f"{err} ({'< 3e-3' if held else 'not held: MoE decode drops collisions'})")
    if held:
        assert err < 3e-3, (cfg.name, err)
    del card_m
    torch.cuda.empty_cache()


def lm_families(T, serve_lib, moe_lib, get_arch, build, dev, card) -> dict:
    """Phase 22: every non-dense LM family served at full width, then each
    checked against a float64 CPU reference at full width."""
    import dataclasses

    import torch

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch, n_layers, n_prefill, n_decode, n_ssd in FAMILY_SERVING:
        cfg = get_arch(arch)
        if n_layers is not None:
            log(f"[families] {arch}: full width, {n_layers} of its {cfg.n_layers} "
                f"layers ({cfg.param_count()} parameters at full depth, "
                f"{2 * cfg.param_count()} B in bf16, past one card's memory)")
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        out[arch] = lm_serving(T, serve_lib, cfg, build, dev, card, n_prefill,
                               n_decode, tag="families", n_ssd=n_ssd)
    for arch, *_ in FAMILY_SERVING:
        family_check(T, moe_lib, get_arch(arch), dev, card)
    log(f"[families] phase 22 in {time.perf_counter() - t_phase:.1f} s | {card}")
    return out


# ----------------------------------------------------------- LM training
def train_step_vs_cpu(T, moe_lib, train_lib, tokens, cfg, dev) -> dict:
    """Phase 23 (a): one f32 train step of a smoke config (its optimizer,
    the Trainer's default schedule: lr 3e-5 at step 1) on the card against
    the CPU, from the same weights and batch (B 2, S 16; whisper with
    seeded frames): the loss, every updated leaf relative to its largest
    entry, and the MoE router's ids of every call."""
    import torch

    from repro_torch.distributed.optimizer import tree_leaves

    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    if cfg.family == "hybrid":  # b_q is zeros at init: give the LoRA product a gradient
        with torch.no_grad():
            b_q = cpu.shared_attn.lora.b_q
            b_q.copy_(torch.randn(b_q.shape, generator=torch.Generator().manual_seed(1)) * 0.5)
    card = T.params_from_jax(T.params_to_numpy(cpu), cfg, dev)
    batch_cfg = tokens.DataConfig(cfg.vocab_size, 2, 16)
    batch = tokens.TokenSource(batch_cfg).global_batch_at(0)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model),
                                      generator=torch.Generator().manual_seed(1))
    ids = {"card": [], "cpu": []}
    side = ["cpu"]
    route = moe_lib.router_topk

    def recording(x, router, top_k):
        probs, got, aux = route(x, router, top_k)
        ids[side[0]].append(got.cpu())
        return probs, got, aux

    out = {}
    moe_lib.router_topk = recording
    try:
        for name, model, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
            side[0] = name
            opt = train_lib.Trainer(cfg, batch_cfg, train_lib.TrainConfig(),
                                    device=d).optimizer
            step = T.train_step_fn(cfg, opt)
            model, _, metrics = step(model, opt.init(T.param_tree(model)),
                                     {k: v.to(d) for k, v in batch.items()})
            out[name] = (float(metrics["loss"]), T.params_to_numpy(model))
    finally:
        moe_lib.router_topk = route
    loss_err = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    leaf_err = max(float(abs(a - b).max() / (abs(b).max() + 1e-30)) for a, b in zip(
        tree_leaves(out["card"][1]), tree_leaves(out["cpu"][1])))
    same = [bool(torch.equal(a, b)) for a, b in zip(ids["card"], ids["cpu"])]
    # one call a MoE layer, and one more where remat recomputes the layer
    n_calls = cfg.n_layers * (2 if cfg.remat == "full" else 1) if cfg.family == "moe" else 0
    log(f"[train] {cfg.name} ({cfg.optimizer}, f32): one step card vs CPU: loss "
        f"{out['card'][0]!r} vs {out['cpu'][0]!r} (rel {loss_err!r} < 1e-5), largest "
        f"leaf error after the update {leaf_err!r} of the leaf's largest (< 1e-5); "
        f"router ids {sum(same)} of {len(same)} calls equal")
    assert loss_err <= 1e-5 and leaf_err <= 1e-5, (cfg.name, loss_err, leaf_err)
    assert len(same) == len(ids["cpu"]) == n_calls and all(same), (cfg.name, same)
    return {"loss_err": loss_err, "leaf_err": leaf_err}


def train_grad_check(T, tokens, cfg, dev, card) -> None:
    """Phase 23 (b): granite at full width, 1 layer, f32, B 1 x S 256: the
    loss, the gradient norm and each gradient leaf on the card against a
    float64 CPU reference of the same weights, relative, < 1e-4."""
    import torch

    from repro_torch.distributed.optimizer import tree_leaves

    t0 = time.perf_counter()
    model = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(3),
                          device=dev)
    ref = T.Transformer(T.weights(model, lambda t: t.detach().to("cpu", torch.float64)), cfg)
    batch = tokens.TokenSource(tokens.DataConfig(cfg.vocab_size, 1, 256, seed=4)).global_batch_at(0)
    (loss, _), grads = T.loss_and_grads(model, {k: v.to(dev) for k, v in batch.items()})
    (want, _), ref_grads = T.loss_and_grads(ref, batch)
    got = [g.to("cpu", torch.float64) for g in tree_leaves(grads)]
    wants = tree_leaves(ref_grads)
    loss_err = abs(float(loss) - float(want)) / abs(float(want))
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in got)))
    ref_norm = float(torch.sqrt(sum(torch.sum(g * g) for g in wants)))
    norm_err = abs(norm - ref_norm) / ref_norm
    leaf_errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, wants)]
    log(f"[train] {cfg.name} full width, {cfg.n_layers} layer, f32, B 1 x S 256: loss "
        f"{float(loss)!r} vs float64 CPU {float(want)!r} (rel {loss_err!r}); gradient "
        f"norm {norm!r} vs {ref_norm!r} (rel {norm_err!r}); largest leaf error relative "
        f"to the leaf's largest {max(leaf_errs)!r} over {len(leaf_errs)} leaves (each "
        f"< 1e-4; {time.perf_counter() - t0:.1f}s) | {card}")
    assert loss_err < 1e-4 and norm_err < 1e-4 and max(leaf_errs) < 1e-4, (
        loss_err, norm_err, leaf_errs)
    del model, ref, grads, ref_grads, got, wants
    torch.cuda.empty_cache()


def train_full_width(T, L, train_lib, tokens, cfg, build, dev, card, timer) -> dict:
    """Phase 23 (c): granite at full width and cut depth, bf16, remat,
    AdamW, B x S = TRAIN_BATCH x TRAIN_SEQ: TRAIN_STEPS steps (finite
    losses; host-clock ms a step, tokens/s, peak device memory), one more
    step under ``torch.profiler`` (device busy and idle share, top
    kernels), ``chunked_attention`` timed alone at the layer's shapes (its
    share of the step's device time), microbatches 2 against 1, and a
    preemption after TRAIN_PREEMPT steps resumed from its checkpoint.  No
    flash launch."""
    import dataclasses
    import math
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    dc = tokens.DataConfig(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    tc = train_lib.TrainConfig(steps=TRAIN_STEPS, warmup_steps=2)
    flash0 = build.FLASH_ATTENTION.launches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = train_lib.Trainer(cfg, dc, tc, device=dev)
    model, opt = tr.init_state()
    n_params = sum(p.numel() for p in model.parameters())
    out = tr.run(params=model, opt=opt)
    straight = out["losses"]
    peak = torch.cuda.max_memory_allocated()
    warm = sorted(list(tr.monitor.times)[1:])  # step 0 is the cold one
    step_s = warm[len(warm) // 2]
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    log(f"[train] {cfg.name} full width, {cfg.n_layers} of {TRAIN_FULL_LAYERS} layers "
        f"({n_params} parameters), {cfg.dtype}, remat {cfg.remat}, {cfg.optimizer}, "
        f"B {TRAIN_BATCH} x S {TRAIN_SEQ}: losses {straight!r}; host-clock ms a step "
        f"{[t * 1e3 for t in tr.monitor.times]!r} (median of the warm steps "
        f"{step_s * 1e3!r} ms, {tok_s!r} tokens/s); peak device memory {peak} B | {card}")
    assert len(straight) == TRAIN_STEPS and all(map(math.isfinite, straight)), straight

    # one more step, profiled
    model, opt = out["params"], out["opt"]
    batch = tr.data.global_batch_at(TRAIN_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, opt, metrics = tr.step(model, opt, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, n = device_us(prof)
    busy /= 1e3
    idle = 1 - busy / wall if wall else float("nan")
    log(f"[profile] train step {cfg.name} ({cfg.n_layers} layers, B {TRAIN_BATCH} x S "
        f"{TRAIN_SEQ}): wall {wall!r} ms (profiled); device busy {busy!r} ms in {n} "
        f"kernels; device idle share {idle!r} | {card}")
    log(f"[profile] train step, top kernels by device time: {top_kernels(prof)}")
    del prof, model, opt, out, metrics, tr
    torch.cuda.empty_cache()

    # chunked_attention alone at the layer's shapes: under remat each layer
    # runs its forward twice and its backward once
    g = torch.Generator(device=dev).manual_seed(9)
    G = cfg.n_heads // cfg.n_kv_heads
    dt = L._dtype(cfg)
    q = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.n_kv_heads, G, cfg.d_head), generator=g,
                    device=dev).to(dt).requires_grad_(True)
    k, v = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.n_kv_heads, cfg.d_head), generator=g,
                        device=dev).to(dt).requires_grad_(True) for _ in range(2))
    do = torch.randn(q.shape, generator=g, device=dev).to(dt)

    def fwd():
        return L.chunked_attention(q, k, v, True, kv_chunk=cfg.kv_chunk)

    t_fwd = timer(lambda: fwd().detach(), reps=3, warmup=1)
    t_fb = timer(lambda: fwd().backward(do), reps=3, warmup=1)
    attn_ms = cfg.n_layers * (t_fwd + t_fb)
    share = attn_ms / busy if busy else float("nan")
    log(f"[train] chunked_attention at B {TRAIN_BATCH} x S {TRAIN_SEQ}, Hq {cfg.n_heads}, "
        f"Hkv {cfg.n_kv_heads}, d {cfg.d_head}, {cfg.dtype}, kv_chunk {cfg.kv_chunk} (CUDA "
        f"events): forward {t_fwd!r} ms, forward + backward {t_fb!r} ms; {cfg.n_layers} "
        f"layers x (2 forwards + 1 backward) = {attn_ms!r} ms, a share {share!r} of the "
        f"profiled step's device busy time | {card}")
    del q, k, v, do
    torch.cuda.empty_cache()

    # microbatches 2 against 1
    tr = train_lib.Trainer(cfg, dc, dataclasses.replace(tc, microbatches=2), device=dev)
    micro = tr.run(stop_after=TRAIN_MICRO_STEPS)["losses"]
    gap = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(micro, straight))
    log(f"[train] microbatches 2: losses {micro!r} vs 1: {straight[:TRAIN_MICRO_STEPS]!r} "
        f"(largest gap {gap!r}, rtol = atol = 2e-3)")
    assert all(abs(a - b) <= 2e-3 + 2e-3 * abs(b) for a, b in zip(micro, straight)), micro
    del tr
    torch.cuda.empty_cache()

    # preempted after TRAIN_PREEMPT steps, resumed from the checkpoint
    d = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        tc_ck = dataclasses.replace(tc, checkpoint_dir=d, checkpoint_every=TRAIN_STEPS + 1)
        t0 = time.perf_counter()
        first = train_lib.Trainer(cfg, dc, tc_ck, device=dev).run(stop_after=TRAIN_PREEMPT)
        t_save = time.perf_counter() - t0
        del first
        torch.cuda.empty_cache()
        tr = train_lib.Trainer(cfg, dc, tc_ck, device=dev)
        t0 = time.perf_counter()
        model, opt, step = tr.restore()  # what run() does on a checkpoint
        t_restore = time.perf_counter() - t0
        tr.ckpt = None  # no second ~12 GB save at the end
        resumed = tr.run(start_step=step, params=model, opt=opt)["losses"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    bit_equal = resumed == straight[TRAIN_PREEMPT:]
    log(f"[train] preempted after {TRAIN_PREEMPT} steps ({t_save:.1f}s with its blocking "
        f"checkpoint), restored at step {step} in {t_restore:.1f}s: losses {resumed!r} vs "
        f"straight {straight[TRAIN_PREEMPT:]!r}; bit-equal {bit_equal}")
    assert step == TRAIN_PREEMPT
    for a, b in zip(resumed, straight[TRAIN_PREEMPT:]):
        assert abs(a - b) <= 1e-6 + 1e-5 * abs(b), (resumed, straight)
    assert len(resumed) == TRAIN_STEPS - TRAIN_PREEMPT
    flash = build.FLASH_ATTENTION.launches - flash0
    log(f"[train] flash launches in the training runs: {flash} (0: training runs "
        f"chunked_attention) | phase (c) {time.perf_counter() - t_phase:.1f}s")
    assert flash == 0, flash
    del model, opt, tr
    torch.cuda.empty_cache()
    return {"step_ms": step_s * 1e3, "tokens_s": tok_s, "peak": peak, "idle": idle,
            "attn_share": share, "busy_ms": busy, "wall_ms": wall, "bit_equal": bit_equal}


def train_pillar(T, tokens, train_lib, cfg, dev) -> None:
    """Phase 23 (d): the JAX package's LM pillar on the card: the granite
    smoke config trained 30 steps at lr 2e-3 (losses fall), then a prefill
    and a decode step from the trained model, finite."""
    import torch

    dc = tokens.DataConfig(cfg.vocab_size, 8, 32)
    out = train_lib.Trainer(cfg, dc, train_lib.TrainConfig(steps=30, warmup_steps=3,
                                                           peak_lr=2e-3), device=dev).run()
    losses = out["losses"]
    with torch.inference_mode():
        cache, lg = T.prefill(out["params"], torch.ones((2, 8), dtype=torch.int32, device=dev),
                              max_len=16)
        cache, lg = T.decode_step(out["params"], cache,
                                  torch.ones((2, 1), dtype=torch.int32, device=dev))
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"[train] pillar {cfg.name}: 30 steps, mean loss of the first 5 {first!r}, of the "
        f"last 5 {last!r}; prefill + decode from the trained model finite "
        f"{bool(torch.isfinite(lg).all())}")
    assert last < first and bool(torch.isfinite(lg).all())


def lm_training(T, get_arch, build, dev, card, timer) -> dict:
    """Phase 23: LM training on the card (see the module docstring)."""
    import dataclasses

    import torch

    from repro_torch.data import tokens
    from repro_torch.distributed import train_loop as train_lib
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib

    from repro_torch.configs import ARCH_IDS

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash0 = build.FLASH_ATTENTION.launches
    for arch in ARCH_IDS:  # the optimizer of each full config (kimi: Adafactor)
        cfg = dataclasses.replace(get_arch(arch, smoke=True), optimizer=get_arch(arch).optimizer)
        train_step_vs_cpu(T, moe_lib, train_lib, tokens, cfg, dev)
    assert build.FLASH_ATTENTION.launches == flash0
    full = get_arch(TRAIN_ARCH)
    train_grad_check(T, tokens, dataclasses.replace(full, n_layers=1, dtype="float32"),
                     dev, card)
    assert build.FLASH_ATTENTION.launches == flash0
    assert full.n_layers == TRAIN_FULL_LAYERS and full.dtype == "bfloat16"
    out = train_full_width(T, L, train_lib, tokens,
                           dataclasses.replace(full, n_layers=TRAIN_LAYERS), build, dev,
                           card, timer)
    train_pillar(T, tokens, train_lib, get_arch(TRAIN_ARCH, smoke=True), dev)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--smoke",
         "--steps", "5"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    log(f"[train] launch.train --smoke (rc {r.returncode}): {r.stdout.strip()}")
    assert r.returncode == 0 and "[train] granite-3-8b: 5 steps" in r.stdout, r.stderr[-3000:]
    log(f"[train] {TRAIN_ARCH} at full width, {TRAIN_LAYERS} of {TRAIN_FULL_LAYERS} layers, "
        f"bf16, remat, AdamW, B {TRAIN_BATCH} x S {TRAIN_SEQ}: {out['step_ms']!r} ms a step "
        f"(host clock, median of the warm steps), {out['tokens_s']!r} tokens/s, peak device "
        f"memory {out['peak']} B, device idle share {out['idle']!r}, chunked_attention "
        f"share {out['attn_share']!r} of device time | {card}")
    log(f"[train] phase 23 in {time.perf_counter() - t_phase:.1f} s | {card}")
    return out


def event_ms(fn, reps: int = 5) -> float:
    """Least device time of one call of ``fn`` between two CUDA events,
    after a warm-up call."""
    import math

    import torch

    fn()
    best = math.inf
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        best = min(best, s.elapsed_time(e))
    return best


def bf16_matmul_rate(dev) -> float:
    """FLOP/s of one 8192^3 bf16 ``torch.matmul`` (least of 5 CUDA-event
    timings after a warm-up)."""
    import torch

    n = 8192
    a = torch.randn((n, n), device=dev, dtype=torch.bfloat16)
    b = torch.randn((n, n), device=dev, dtype=torch.bfloat16)
    ms = event_ms(lambda: a @ b)
    del a, b
    return 2.0 * n**3 / (ms * 1e-3)


def hbm_bw(dev) -> float:
    """Streaming bandwidth of an elementwise add over 256 MiB in and 256
    MiB out: more than 4x the card's L2, so the reads come from HBM."""
    import torch

    props = torch.cuda.get_device_properties(dev)
    n = max(64 * 2**20, int(props.L2_cache_size))  # f32: 4 n B >= 4x L2
    x = torch.zeros(n, device=dev)
    y = torch.empty_like(x)
    ms = event_ms(lambda: torch.add(x, 1.0, out=y))
    return 2.0 * 4.0 * n / (ms * 1e-3)


def dry_profile(dev, card):
    """The roofline profile of phase 24: a measured bf16 matmul rate and
    streaming bandwidth; no link (one card)."""
    import dataclasses

    from repro_torch.roofline import costmodel

    rate, bw = bf16_matmul_rate(dev), hbm_bw(dev)
    log(f"[dryrun] profile: bf16 matmul 8192^3 {rate!r} FLOP/s, streaming {bw!r} B/s "
        f"(CUDA events) | {card}")
    return dataclasses.replace(costmodel.PROFILES["h100-sxm"], name="h100-bf16-measured",
                               peak_flops=rate, hbm_bw=bw)


def dry_vs_card(T, get_arch, dev, card, prof, step_ms) -> dict:
    """Phase 24 (a): phase 23's cell through the dry run on a (1, 1) mesh,
    then the same step once on the card (see the module docstring)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    import repro_torch.configs as C
    from repro_torch.distributed.optimizer import Schedule, make_optimizer
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.roofline import analysis

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    shape = C.ShapeSpec("train_b4_s2048", "train", TRAIN_SEQ, TRAIN_BATCH)
    C.SHAPES.setdefault(shape.name, shape)  # the analysis reads the cell's shape by name
    t0 = time.perf_counter()
    dryrun.init_fake_world(1)
    try:
        res = dryrun.run_step(dryrun.build_step(cfg, shape, make_mesh((1, 1), ("data", "model"))),
                              1)
    finally:
        T.set_mesh(None)
        dist.destroy_process_group()
    t_dry = time.perf_counter() - t0
    mem, cost = res["memory_analysis"], res["cost_analysis"]
    dry_peak = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    log(f"[dryrun] (a) {cfg.name} {cfg.n_layers} of {TRAIN_FULL_LAYERS} layers, B "
        f"{TRAIN_BATCH} x S {TRAIN_SEQ}, (1, 1) mesh, fake tensors, {t_dry:.1f}s: "
        f"memory {mem}, cost {cost}, collective total {res['collective_bytes']['total']}")

    # the same step once on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = make_optimizer(cfg.optimizer, Schedule())
    params = T.param_tree(model)
    state = opt.init(params)
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=g,
                              device=dev, dtype=torch.int32) for k in ("tokens", "labels")}
    arg_bytes = sum(t.numel() * t.element_size()
                    for t in dryrun._leaves((params, state, batch)))
    step = T.train_step_fn(cfg, opt)

    def run(mode=None):
        """One step (under ``mode``, if any): its peak over what was
        allocated before the model."""
        nonlocal model, state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with mode if mode is not None else contextlib.nullcontext():
            model, state, metrics = step(model, state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - before, loss

    base = torch.cuda.memory_allocated()
    card_peak, loss = run()  # the step the dry run is held to
    fc = FlopCounterMode(display=False)
    fc_peak, _ = run(fc)
    flops = fc.get_total_flops()
    counter = dryrun._Counter()  # the dry run's counter on the card's own tensors
    for t in dryrun._leaves((T.param_tree(model), state, batch, T._view(model).grads)):
        counter.hold(t)
    counter_peak, _ = run(counter)
    again, _ = run()
    log(f"[dryrun] (a) card step: loss {loss!r}; arguments {arg_bytes} B (dry run "
        f"{mem['argument_size_in_bytes']}); allocated before the model {before} B, "
        f"before the step {base} B; step peak over what was allocated before the model "
        f"{card_peak} B (dry run peak {dry_peak} B, {dry_peak / card_peak - 1:+.4f}); the "
        f"next steps: under FlopCounterMode {flops} FLOPs (dry run {cost['flops']!r}), "
        f"peak {fc_peak} B; under the dry run's counter: its tracked peak {counter.peak} "
        f"B, FLOPs {counter.flops}, allocator peak {counter_peak} B; plain again, peak "
        f"{again} B | {card}")
    del model, state, batch, params, counter, fc
    torch.cuda.empty_cache()

    cell = {"arch": TRAIN_ARCH, "shape": shape.name, "mesh": "1x1", "status": "ok",
            "n_chips": 1, "active_params": cfg.active_param_count(), **res}
    row = analysis.analyze_cell(cell, prof)
    log(f"[dryrun] (a) roofline under {prof.name}: compute_s {row.compute_s!r}, memory_s "
        f"{row.memory_s!r} (fused bound {row.memory_min_s!r}), collective_s "
        f"{row.collective_s!r}, dominant {row.dominant}, roofline_fraction "
        f"{row.roofline_fraction!r}, useful_ratio {row.useful_ratio!r}; measured step "
        f"{step_ms!r} ms (phase 23, host clock) | {card}")
    assert cost["flops"] == flops, (cost["flops"], flops)
    assert mem["argument_size_in_bytes"] == arg_bytes, (mem, arg_bytes)
    assert abs(dry_peak - card_peak) <= DRY_PEAK_TOL * card_peak, (dry_peak, card_peak)
    assert 0 < row.roofline_fraction <= 1.05, row
    return {"flops": flops, "dry_peak": dry_peak, "card_peak": card_peak,
            "compute_s": row.compute_s, "memory_s": row.memory_s, "dominant": row.dominant,
            "fraction": row.roofline_fraction}


def dry_spec_bytes(arch: str, shape_name: str, mesh_kind: str) -> int:
    """Phase 24 (b): a cell's argument bytes from the specs alone: the local
    shard bytes of the parameters (and the optimizer state, or the decode
    cache) and the batch on the production mesh."""
    import repro_torch.configs as C
    from repro_torch.distributed import sharding
    from repro_torch.distributed.optimizer import Schedule, make_optimizer
    from repro_torch.distributed.train_loop import _opt_specs
    from repro_torch.launch import dryrun

    class Named:
        axis_names = ("pod", "data", "model") if mesh_kind == "multi" else ("data", "model")
        shape = dict(zip(axis_names, (2, 16, 16) if mesh_kind == "multi" else (16, 16)))

    m = Named()
    cfg, shape = C.get_arch(arch), C.SHAPES[shape_name]
    p = dryrun._param_shapes(cfg)
    total = sharding.local_bytes(
        p, sharding.param_specs(p, m, serve=dryrun.serve_replicated(cfg, shape, m)), m)
    inputs = C.input_specs(cfg, shape)
    total += sharding.local_bytes(inputs, sharding.batch_specs(inputs, m), m)
    if shape.kind == "train":
        o = make_optimizer(cfg.optimizer, Schedule()).init(p)
        total += sharding.local_bytes(o, _opt_specs(o, p, m), m)
    elif shape.kind == "decode":
        c = dryrun._cache_shapes(cfg, shape.global_batch, shape.seq_len)
        total += sharding.local_bytes(c, sharding.cache_specs(c, m), m)
    return total


def dry_cells_start(logs: pathlib.Path) -> list:
    """Phase 24 (b): every cell's ``python -m repro_torch.launch.dryrun``,
    started at once (each a fresh process and process group), its output
    in a file under ``logs``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for cell in DRY_CELLS:
        out = open(logs / ("__".join(cell) + ".log"), "w")
        procs.append((cell, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0], "--shape",
             cell[1], "--mesh", cell[2]], cwd=ROOT, env=env, stdout=out,
            stderr=subprocess.STDOUT)))
    return procs


def dry_cells_check(procs, prof, card) -> None:
    """Phase 24 (b): each cell's result read back and checked."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis

    for (arch, shape, mesh), out, proc in procs:
        proc.wait(timeout=900)
        out.close()
        assert proc.returncode == 0, (arch, shape, mesh, open(out.name).read()[-4000:])
        with open(ROOT / dryrun.RESULTS_DIR / f"{arch}__{shape}__{mesh}.json") as f:
            cell = json.load(f)
        mem, coll = cell["memory_analysis"], cell["collective_bytes"]
        want = dry_spec_bytes(arch, shape, mesh)
        row = analysis.analyze_cell(cell, prof)
        log(f"[dryrun] (b) {arch} x {shape} x {mesh} ({cell['n_chips']} ranks, trace "
            f"{cell['trace_s']}s): status {cell['status']}; per device: memory {mem} (peak "
            f"{row.peak_mem_gb!r} GB); flops {cell['cost_analysis']['flops']!r}, bytes "
            f"accessed {cell['cost_analysis']['bytes accessed']!r}; collective bytes "
            f"{ {k: coll[k] for k in ('all-gather', 'all-reduce', 'reduce-scatter', 'all-to-all', 'collective-permute', 'total')} } "
            f"counts {coll['counts']}; argument bytes from the specs {want}")
        log(f"[dryrun] (b)   row under {prof.name}: compute_s {row.compute_s!r}, memory_s "
            f"{row.memory_s!r} / fused {row.memory_min_s!r}, collective_s "
            f"{row.collective_s!r} ({row.note}), dominant {row.dominant}, useful_ratio "
            f"{row.useful_ratio!r}, roofline_fraction {row.roofline_fraction!r} | {card}")
        assert cell["status"] == "ok" and coll["total"] > 0, cell["status"]
        assert mem["argument_size_in_bytes"] == want, (arch, shape, mesh, mem, want)


def dry_run(T, get_arch, dev, card, step_ms) -> dict:
    """Phase 24: the dry run (see the module docstring)."""
    t_phase = time.perf_counter()
    logs = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    procs = dry_cells_start(logs)
    try:
        prof = dry_profile(dev, card)
        out = dry_vs_card(T, get_arch, dev, card, prof, step_ms)
        dry_cells_check(procs, prof, card)
    finally:
        for _, f, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
    log(f"[dryrun] phase 24 in {time.perf_counter() - t_phase:.1f} s | {card}")
    return out


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

    from repro_torch import dse
    from repro_torch.configs.tnn_columns import (
        all_benchmarks, column_config, hardware_spec,
    )
    from repro_torch.core import column, network, simulator
    from repro_torch.core.types import (
        ColumnConfig, LayerConfig, NetworkConfig, STDPConfig,
    )
    from repro_torch.data import ucr
    from repro_torch.hwgen import run_flow
    from repro_torch.hwgen.rtl import ColumnSpec
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, fused_column, rnl_response, stdp_update
    from repro_torch.kernels import flash_attention as flash_lib
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    card = card_line()
    device_kind = torch.cuda.get_device_name(0)
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
        w = half_grid(rng, (d, p, q))
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
        (2, 650, 130, 2, True, True),  # the device-memory layout
    ):
        w, t_f32, ops = fused_case(d, p, q, seed=d * 1000 + p + q + k_, hetero=hetero)
        kw = dict(t_window=64, w_max=7, wta_k=k_, stabilize=stab)
        for t_in in (t_f32, t_f32.to(torch.int32)):
            w_ref, y_ref = fused_column.fused_step_padded_plain(w, t_in, ops, **kw)
            w_k, y_k = fused_column.fused_step_padded(
                w.to(dev), t_in.to(dev), ops.to(dev), **kw)
            torch.cuda.synchronize()
            dw = float((w_k.cpu() - w_ref).abs().max())
            dy = float((y_k.cpu() - y_ref).abs().max())
            err["fused_step"] = max(err["fused_step"], dw, dy)
            log(f"[fused_step] D={d} {p}x{q} k={k_} stabilize={stab} "
                f"times={t_in.dtype} max|dw|={dw} max|dy|={dy} "
                f"{layout_name(build.FUSED_STEP, p, q, 64)}")
            assert torch.equal(y_k.cpu(), y_ref), "fused_step: winner times differ"
            assert torch.equal(w_k.cpu(), w_ref), "fused_step: weights differ"
    err["fused_step"] = max(err["fused_step"],
                            check_fused_fit(fused_column, build, dev))

    # 3 — RNL fire against its plain version (on the card, on the same
    # tensors): int32 times (the slope histogram), f32 x + 0.5 and int32
    # with negative times (the ramp sum), and int32 with negative times in
    # volley 0 only (one launch, both forms)
    for b, p, q in ((905, 270, 25), (121, 637, 2), (121, 650, 130)):
        rng = np.random.default_rng(b)
        w = torch.from_numpy(rng.integers(0, 15, (p, q)).astype(np.float32) / 2).to(dev)
        thr = 0.25 * p * 3.5
        for times in ("int", "half", "neg", "mixed"):
            t_in = torch.from_numpy(fit_volleys(rng, times, (b, p), 64)).to(dev)
            ref = rnl_response.rnl_fire_plain(t_in, w, thr, 64, 7)
            got = rnl_response.rnl_fire(t_in, w, thr, 64, 7)
            torch.cuda.synchronize()
            diff = float((got - ref).abs().max())
            err["rnl_fire"] = max(err["rnl_fire"], diff)
            log(f"[rnl_fire] B={b} {p}x{q} {times} times={t_in.dtype} max|dt|={diff} "
                f"{layout_name(build.RNL_FIRE, p, q, 64)}")
            assert torch.equal(got, ref), "rnl_fire: firing times differ"

    # 4, 5 — the padded kernels against their plain versions
    err["fused_block"] = max(check_fused_block(fused_column, dev),
                             check_block_split(fused_column, build, dev))
    err["fire_block"] = check_fire_block(fused_column, dev)

    # 6 — the STDP update against its plain version
    err["stdp_update"] = check_stdp_update(stdp_update, dev)

    # 7 — the single-column path, launch counters reset just before it
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
    # the RNL-fire inputs of the path ('pallas' only: 'auto' fires none)
    rnl_calls: list = []
    unwrap = record_calls(rnl_response, "rnl_fire", rnl_calls)
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
            assert grew["fused_step"] == 1, grew  # the whole fit, one launch
            if mode == "pallas":
                assert grew["rnl_fire"] >= 1, grew
            else:
                assert grew["rnl_fire"] == 0, grew
    launches = {k.name: k.launches for k in build.KERNELS}
    unwrap()
    log(f"[main] launches over the single-column path: {launches}")
    for k in (build.FUSED_STEP, build.RNL_FIRE):
        assert launches[k.name] > 0, f"{k.name} never launched on its path"
    # 3, second half — the RNL fire on the 'pallas' path's own inputs: the
    # path's int32 times reach the kernel as they are
    assert len(rnl_calls) == launches["rnl_fire"], (len(rnl_calls), launches)
    for (t_in, w, *args), _ in rnl_calls:
        assert t_in.dtype == torch.int32, ("rnl_fire reached with", t_in.dtype)
        got = rnl_response.rnl_fire(t_in, w, *args)
        ref = rnl_response.rnl_fire_plain(t_in, w, *args)
        diff = float((got - ref).abs().max())
        err["rnl_fire"] = max(err["rnl_fire"], diff)
        log(f"[rnl_fire] path call B={t_in.shape[0]} {w.shape[0]}x{w.shape[1]} "
            f"times={t_in.dtype} max|dt|={diff}")
        assert torch.equal(got, ref), "rnl_fire: firing times differ on the path"

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

    # 8 — the sweep path, launch counters reset just before it
    ws = designs["WordSynonyms"][1]
    n_ws = ws.x.shape[0]
    blocks = -(-n_ws // 32)
    sweeps = {}
    fire_calls: list = []  # the integer-grid sweep's batched-fire inputs
    for k in build.KERNELS:
        k.launches = 0
    for name, grid, max_bucket, seed in (("default", False, None, 1),
                                         ("grid", True, 8, 2)):
        cfgs = sweep_designs(ColumnConfig, STDPConfig, simulator, grid)
        w_init = sweep_w_init(cfgs, grid, seed)
        before = {k.name: k.launches for k in build.KERNELS}
        unwrap = record_calls(fused_column, "fire_block_padded", fire_calls)
        try:
            res = simulator.cluster_time_series_many(
                ws.x, ws.y, cfgs, epochs=EPOCHS, w_init=w_init,
                max_bucket=max_bucket, device="cuda")
        finally:
            unwrap()
        grew = {k.name: k.launches - before[k.name] for k in build.KERNELS}
        sweeps[name] = (cfgs, w_init, res)
        n_b = res[0].buckets
        log(f"[sweep] {name} D={len(cfgs)} 270x(25,50) N={n_ws} buckets={n_b} "
            f"train_seconds={res[0].train_seconds!r} launches={grew} card={card}")
        for c, r in zip(cfgs, res):
            log(f"[sweep] {name} q={c.q} t_max={c.t_max} "
                f"threshold={c.neuron.threshold} RI={r.rand_index!r} "
                f"lowering={r.lowering} retries={r.retries} plan={r.plan}")
            assert isinstance(r, simulator.ClusteringResult), r
            assert r.lowering == "cuda" and r.retries == 0, (r.lowering, r.retries)
            assert r.assignments.shape == (n_ws,)
            assert np.all((r.assignments >= 0) & (r.assignments <= c.q))
            assert bool(torch.isfinite(r.params["w"]).all())
            assert 0.0 <= r.rand_index <= 1.0
        assert n_b == (2 if grid else 1), n_b
        assert grew["fused_block"] == n_b * EPOCHS * blocks, grew
        assert grew["fused_step"] == 0 and grew["rnl_fire"] == 0, grew
        if grid:
            assert grew["fire_block"] >= 1 and grew["fire_float"] == 0, grew
        else:  # float weights: one float-weight fire a bucket
            assert grew["fire_block"] == 0 and grew["fire_float"] == n_b, grew
        assert len(fire_calls) == grew["fire_block"], len(fire_calls)

    # assignment alone, one integer-grid design
    cfgs, _, res = sweeps["grid"]
    before = build.FIRE_BLOCK.launches
    ids = simulator.assign_time_series(ws.x, cfgs[1], res[1].params, device="cuda")
    log(f"[assign] grid design 1 equal to its sweep ids="
        f"{bool(np.array_equal(ids, res[1].assignments))} fire_block launches="
        f"{build.FIRE_BLOCK.launches - before}")
    assert build.FIRE_BLOCK.launches - before == 1
    assert np.array_equal(ids, res[1].assignments)

    # two-layer network shaped like examples/design_nspu.py: two full
    # columns feed a read-out column.  Only one input per upstream column
    # spikes (1-WTA), so the read-out's threshold is a quarter of those two
    # inputs' saturated potential, as suggest_threshold sets it for p live
    # inputs
    c1 = ColumnConfig(p=270, q=25, t_max=64)
    c1 = c1.with_threshold(simulator.suggest_threshold(c1))
    c2 = ColumnConfig(p=50, q=25, t_max=64).with_threshold(0.25 * 2 * 7)
    net = NetworkConfig(layers=(LayerConfig(columns=2, column=c1),
                                LayerConfig(columns=1, column=c2)))
    net_w0 = network.init_params(net, 270, torch.Generator().manual_seed(0), "cpu")
    before = build.FUSED_BLOCK.launches
    net_res = simulator.cluster_time_series_network(
        ws.x, ws.y, net, epochs=EPOCHS, device="cuda", params=net_w0)
    grew = build.FUSED_BLOCK.launches - before
    log(f"[network] 2x270x25 -> 1x50x25 N={n_ws} RI={net_res.rand_index!r} "
        f"train_seconds={net_res.train_seconds!r} lowering={net_res.lowering} "
        f"fused_block launches={grew} card={card}")
    assert net_res.lowering == "cuda"
    assert grew == 2 * EPOCHS * blocks, grew
    assert net_res.assignments.shape == (n_ws,)
    assert 0.0 <= net_res.rand_index <= 1.0
    sweep_launches = {k.name: k.launches for k in build.KERNELS}
    log(f"[sweep] launches over the sweep path: {sweep_launches}")
    for k in (build.FUSED_BLOCK, build.FIRE_BLOCK):
        assert sweep_launches[k.name] > 0, f"{k.name} never launched on its path"
    assert sweep_launches["fused_step"] == 0

    # 5, second half — the batched fire on the sweep path's own inputs
    err["fire_block"] = max(err["fire_block"],
                            check_path_fire_calls(fused_column, fire_calls))

    # 9 — the sweep path on the CPU from the same initial weights; a
    # 2-design sweep is a valid comparison, since no result depends on
    # the bucket a design rides in
    for name, (cfgs, w_init, res) in sweeps.items():
        pick = (0, 11)
        t0 = time.perf_counter()
        cpu = simulator.cluster_time_series_many(
            ws.x, ws.y, [cfgs[i] for i in pick], epochs=EPOCHS,
            w_init=[w_init[i] for i in pick], device="cpu")
        for j, i in enumerate(pick):
            same_a = bool(np.array_equal(cpu[j].assignments, res[i].assignments))
            same_w = torch.equal(cpu[j].params["w"], res[i].params["w"].cpu())
            log(f"[cpu-check] {name} design {i} equal_assignments={same_a} "
                f"RI cpu={cpu[j].rand_index!r} card={res[i].rand_index!r} "
                f"weights equal={same_w} cpu_seconds={time.perf_counter() - t0:.1f}")
            assert cpu[j].lowering == "reference"
            assert same_a and same_w, f"{name} design {i}: card and CPU differ"
            assert cpu[j].rand_index == res[i].rand_index
    cpu_net = simulator.cluster_time_series_network(
        ws.x, ws.y, net, epochs=EPOCHS, device="cpu", params=net_w0)
    same_w = all(torch.equal(a["w"], b["w"].cpu()) for a, b in zip(
        cpu_net.params["layers"], net_res.params["layers"]))
    same_a = bool(np.array_equal(cpu_net.assignments, net_res.assignments))
    log(f"[cpu-check] network equal_assignments={same_a} RI cpu="
        f"{cpu_net.rand_index!r} card={net_res.rand_index!r} weights equal={same_w}")
    assert same_a and same_w and cpu_net.rand_index == net_res.rand_index

    # 10 — the ops path at full width, launch counters reset just before
    # it: WordSynonyms 270 x 25, all volleys, default STDP, one epoch
    cfg_ws, _, w0_ws = designs["WordSynonyms"]
    vol_ws = simulator._encode(
        torch.as_tensor(ws.x, dtype=torch.float32, device=dev), cfg_ws, "latency")
    w_start = w0_ws["w"].to(dev)
    stdp_path_inputs = None  # the first volley's STDP-update operands
    for k in build.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_loop = w_start
    for i in range(n_ws):
        y = kops.column_forward({"w": w_loop}, vol_ws[i : i + 1], cfg_ws)
        if stdp_path_inputs is None:
            stdp_path_inputs = (w_loop.clone(), vol_ws[i].clone(), y[0].clone())
        w_loop = kops.stdp_step(w_loop, vol_ws[i], y[0], cfg_ws)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w_fused = kops.train_volleys({"w": w_start}, vol_ws, cfg_ws)["w"]
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    ops_launches = {k.name: k.launches for k in build.KERNELS}
    w_cpu = kops.train_volleys({"w": w_start.cpu()}, vol_ws.cpu(), cfg_ws)["w"]
    log(f"[ops] WordSynonyms 270x25 N={n_ws} 1 epoch: unfused loop "
        f"(column_forward -> stdp_step) seconds={loop_s!r}, train_volleys "
        f"seconds={fused_s!r}; launches={ops_launches}; loop == fused "
        f"{torch.equal(w_loop, w_fused)}; fused == CPU "
        f"{torch.equal(w_fused.cpu(), w_cpu)} | {card}")
    assert ops_launches == {k.name: 0 for k in build.KERNELS} | {
        "fused_step": 1, "rnl_fire": n_ws, "stdp_update": n_ws}, ops_launches
    assert torch.equal(w_loop, w_fused), "ops: unfused loop and train_volleys differ"
    assert torch.equal(w_fused.cpu(), w_cpu), "ops: card and CPU differ"
    assert not torch.equal(w_fused, w_start)

    # 11 — the DSE path at full width, launch counters reset just before it
    space = dse.DesignSpace(q=(25, 50), t_max=(32, 64),
                            threshold_scale=(0.75, 1.0, 1.25),
                            encoder=("latency", "onoff"))
    for k in build.KERNELS:
        k.launches = 0
    float_calls: list = []  # the float-weight fire's inputs, a bucket each
    unwrap = record_calls(fused_column, "fire_float_padded", float_calls)
    t0 = time.perf_counter()
    try:
        res_dse = dse.explore(ws.x, ws.y, space, epochs=DSE_EPOCHS, device="cuda")
    finally:
        unwrap()
    dse_s = time.perf_counter() - t0
    dse_launches = {k.name: k.launches for k in build.KERNELS}
    per_epoch = {
        enc: sum(len(fused_column.block_sub_launches(p_env, 50, 32, nv, 64))
                 for nv in n_valid_per_block(n_ws, 32))
        for enc, p_env in (("latency", 270), ("onoff", 540))
    }
    log(f"[dse] WordSynonyms N={n_ws} {len(res_dse.points)} points, "
        f"{DSE_EPOCHS} epochs: seconds={dse_s!r} meta seconds="
        f"{res_dse.seconds!r} buckets={res_dse.meta['buckets']} lowering="
        f"{res_dse.meta['lowering']} quarantined={res_dse.meta['quarantined']} "
        f"retries={res_dse.meta['retries']} launches={dse_launches} "
        f"volley-block launches per epoch={per_epoch} | {card}")
    log(dse.summarize(res_dse))
    assert res_dse.meta["quarantined"] == 0, res_dse.meta["failures"]
    assert res_dse.meta["retries"] == 0
    assert len(res_dse.points) == space.size() == 24
    assert res_dse.meta["buckets"] == {"latency": 1, "onoff": 1}
    for pt in res_dse.points:
        assert pt.lowering == "cuda" and pt.retries == 0, (pt.index, pt.lowering)
        assert pt.plan["v_blk"] == 32, pt.plan
        assert 0.0 <= pt.rand_index <= 1.0
        assert np.all(np.isfinite(pt.params["w"]))
    assert dse_launches["fused_block"] == DSE_EPOCHS * sum(per_epoch.values())
    assert dse_launches["fused_step"] == dse_launches["rnl_fire"] == 0
    assert dse_launches["stdp_update"] == dse_launches["fire_block"] == 0
    assert dse_launches["fire_float"] == len(float_calls) == 2, dse_launches
    err["fire_float"] = check_path_fire_calls(fused_column, float_calls, "fire_float")

    class CountingJournal(dse.Journal):
        """Remembers how many records each bucket appended."""

        def __init__(self, path):
            super().__init__(path)
            self.sizes = []

        def append(self, records):
            self.sizes.append(len(records))
            super().append(records)

    def same_run(a, b) -> bool:
        return (
            [p.index for p in a.points] == [p.index for p in b.points]
            and all(p.rand_index == r.rand_index
                    and np.array_equal(p.params["w"], r.params["w"])
                    for p, r in zip(a.points, b.points))
            and [p.index for p in a.pareto] == [p.index for p in b.pareto])

    with tempfile.TemporaryDirectory() as tmp:
        jr = CountingJournal(os.path.join(tmp, "dse.jsonl"))
        res_j = dse.explore(ws.x, ws.y, space, epochs=DSE_EPOCHS, journal=jr,
                            device="cuda")
        with open(jr.path) as f:
            lines = f.read().splitlines()
        cut = os.path.join(tmp, "killed.jsonl")  # a kill after bucket one
        with open(cut, "w") as f:
            f.write("\n".join(lines[: 1 + jr.sizes[0]]) + "\n")
        before = build.FUSED_BLOCK.launches
        res_r = dse.explore(ws.x, ws.y, space, epochs=DSE_EPOCHS, journal=cut,
                            resume=True, device="cuda")
        resumed_launches = build.FUSED_BLOCK.launches - before
    log(f"[dse] journal: bucket records {jr.sizes}; resumed "
        f"{res_r.meta['resumed']} of {len(res_r.points)}, volley-block launches "
        f"on resume {resumed_launches}; journaled run == run "
        f"{same_run(res_j, res_dse)}; resumed run == run {same_run(res_r, res_dse)}")
    assert res_r.meta["resumed"] == jr.sizes[0] == 12
    assert resumed_launches == DSE_EPOCHS * per_epoch["onoff"]
    assert same_run(res_j, res_dse) and same_run(res_r, res_dse)

    for i in DSE_CPU_CHECKED:
        pt = res_dse.points[i]
        t0 = time.perf_counter()
        cpu = simulator.cluster_time_series_many(
            ws.x, ws.y, [pt.cfg], epochs=DSE_EPOCHS, encoder=pt.encoder,
            w_init=[dse.initial_weights(0, i, pt.cfg)], device="cpu")[0]
        ids = simulator.assign_time_series(ws.x, pt.cfg, pt.params,
                                           encoder=pt.encoder, device="cuda")
        same_a = bool(np.array_equal(cpu.assignments, ids))
        same_w = bool(np.array_equal(cpu.params["w"].numpy(), pt.params["w"]))
        log(f"[cpu-check] dse candidate {i} ({pt.encoder} {pt.cfg.p}x{pt.cfg.q} "
            f"t_max={pt.cfg.t_max}) equal_ids={same_a} RI cpu="
            f"{cpu.rand_index!r} card={pt.rand_index!r} weights equal={same_w} "
            f"cpu_seconds={time.perf_counter() - t0:.1f}")
        assert cpu.lowering == "reference"
        assert same_a and same_w and cpu.rand_index == pt.rand_index, i

    # 12 — the hardware generator on the chosen design (host only)
    bp = res_dse.best()
    with tempfile.TemporaryDirectory() as tmp:
        spec = ColumnSpec(name="wordsynonyms_nspu", p=bp.cfg.p, q=bp.cfg.q,
                          theta=int(bp.cfg.p * 7 // 8), t_max=bp.cfg.t_max)
        fr = run_flow(spec, "tnn7", build_root=tmp)
        written = sorted(os.listdir(fr.build_dir))
        log(f"[hwgen] best design {bp.index} ({bp.encoder} {bp.cfg.p}x{bp.cfg.q} "
            f"t_max={bp.cfg.t_max}, RI {bp.rand_index!r}): post-layout "
            f"{fr.area_um2!r} um^2, {fr.leakage_uw!r} uW, forecast "
            f"{bp.area_um2!r} um^2, error "
            f"{100 * (bp.area_um2 - fr.area_um2) / fr.area_um2:+.2f}%; "
            f"files {written}")
        assert f"tnn_column_{spec.name}.v" in written and "synth_tnn7.tcl" in written
        assert fr.synapses == bp.synapses and fr.area_um2 > 0
        for name in all_benchmarks():
            fr = run_flow(hardware_spec(name), "tnn7", build_root=tmp)
            log(f"[hwgen] {name} {fr.synapses} synapses: {fr.area_um2!r} um^2 "
                f"{fr.leakage_uw!r} uW latency {fr.latency_ns!r} ns")
            assert fr.area_um2 > 0 and fr.leakage_uw > 0

    # 13 — the sweep that needed the device-memory layout
    repair_sweep(simulator, ColumnConfig, build, ucr, dev, card)

    # 14 — the flash kernel against its plain version; f32 products in
    # full f32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err["flash_attention"] = check_flash(flash_lib, dev)

    # 15, 16 — the LM slice at 2 layers, then the serving path
    lm_cfg = get_arch(LM_ARCH)
    lm_slice_checks(T, lm_cfg, dev)
    torch.cuda.empty_cache()
    lm = lm_serving(T, serve_lib, lm_cfg, build, dev, card)
    torch.cuda.empty_cache()

    # 17 — timing at the paths' shapes
    timer = Timer(torch)
    rows = {}
    for name, (cfg, ds, w0) in designs.items():
        res = results[(name, "pallas")]
        w = res.params["w"].contiguous()
        x = simulator._encode(
            torch.as_tensor(ds.x, dtype=torch.float32, device=dev), cfg, "latency")
        p, q, t_max = cfg.p, cfg.q, cfg.t_max
        n = x.shape[0]
        ops = fused_column.design_operands(
            [cfg.neuron.threshold], [t_max], [q], cfg.stdp.mu_capture,
            cfg.stdp.mu_backoff, cfg.stdp.mu_search, device=dev)
        step = dict(t_window=t_max, w_max=cfg.neuron.w_max, wta_k=cfg.wta.k,
                    stabilize=cfg.stdp.stabilizer == "half")
        # fused step, the whole fit in one launch, as the path calls it:
        # the path's initial weights and int32 volleys, no trace
        wf = w0["w"].to(dev)[None].contiguous()
        xs = x[None].contiguous()
        fit_kw = dict(step, epochs=EPOCHS)
        fit_ms = timer(lambda: fused_column.fused_fit_padded(wf, xs, ops, **fit_kw),
                       5, warmup=1)
        n_vol = EPOCHS * n
        # one volley (the first series) on the trained weights, with the
        # path's int32 times and as f32
        w3 = w[None].contiguous()
        xt = x[:1].contiguous()
        xf = xt.to(torch.float32)
        xf_all = x.to(torch.float32)
        f_ms = timer(lambda: fused_column.fused_step_padded(w3, xt, ops, **step), 400)
        f32_ms = timer(lambda: fused_column.fused_step_padded(w3, xf, ops, **step), 400)
        f_plain = timer(lambda: fused_column.fused_step_padded_plain(w3, xt, ops, **step), 100)
        f_bytes, f_ops, f_ramp = fit_bound(fused_column, w3, xt[:, None], ops,
                                           dict(step, epochs=1), last=True)
        # RNL fire: the main path's assignment call, every volley, on the
        # path's int32 times (the slope form) and on the same times as f32
        # (the ramp sum)
        r_args = (cfg.neuron.threshold, t_max, cfg.neuron.w_max)
        r_ms = timer(lambda: rnl_response.rnl_fire(x, w, *r_args), 50)
        r32_ms = timer(lambda: rnl_response.rnl_fire(xf_all, w, *r_args), 50)
        r_plain = timer(lambda: rnl_response.rnl_fire_plain(x, w, *r_args), 5,
                        warmup=1)
        r_bytes, r_ops, r_ramp = rnl_bound(rnl_response, x, w, *r_args)
        rows[name] = dict(
            one=(f_ms, f_plain, *bound_ms(f_bytes, f_ops), f_bytes, f_ops),
            rnl=(r_ms, r_plain, *bound_ms(r_bytes, r_ops), r_bytes, r_ops, n),
        )
        log(f"[time] {name} {p}x{q} fused_step whole fit N={n} x {EPOCHS} epochs, "
            f"one launch: ms={fit_ms!r} us/volley={1e3 * fit_ms / n_vol!r} | "
            f"one volley, int32 times: ms={f_ms!r}, f32 times: ms={f32_ms!r}, "
            f"plain_ms={f_plain!r} bound_ms={rows[name]['one'][2]!r} "
            f"({rows[name]['one'][3]}; {f_bytes} B, {f_ops} ops of the slope form, "
            f"{f_ramp} of the ramp sum) | rnl_fire B={n} int32 times ms={r_ms!r}, "
            f"f32 times ms={r32_ms!r}, plain_ms={r_plain!r} "
            f"bound_ms={rows[name]['rnl'][2]!r} ({rows[name]['rnl'][3]}; {r_bytes} B, "
            f"{r_ops} ops of the slope form; the ramp sum's {r_ramp} ops, "
            f"{bound_ms(r_bytes, r_ramp)[0]!r} ms) | {card}")
        if name != "WordSynonyms":
            continue
        # the plain fold over the same whole fit, one timed call (host-bound:
        # a few launches a volley)
        fit_plain = timer(lambda: fused_column.fused_fit_padded_plain(
            wf, xs, ops, **fit_kw), 1, warmup=0)
        fit_bytes, fit_ops, fit_ramp = fit_bound(fused_column, wf, xs, ops, fit_kw)
        traced_ms = timer(lambda: fused_column.fused_fit_padded(
            wf, xs, ops, trace=True, **fit_kw), 5, warmup=1)
        rows[name]["fit"] = (fit_ms, fit_plain,
                             *bound_ms(fit_bytes, fit_ops), fit_bytes, fit_ops)
        log(f"[time] {name} {p}x{q} fused_step whole fit N={n} x {EPOCHS} epochs "
            f"({n_vol} volleys), one launch: ms={fit_ms!r} "
            f"us/volley={1e3 * fit_ms / n_vol!r}; with the trace ms={traced_ms!r}; "
            f"plain fold over the whole fit ms={fit_plain!r}; "
            f"bound_ms={rows[name]['fit'][2]!r} ({rows[name]['fit'][3]}; "
            f"{fit_bytes} B, {fit_ops} ops of the slope form; the ramp sum's "
            f"{fit_ramp} ops, {bound_ms(fit_bytes, fit_ramp)[0]!r} ms) | {card}")

    # the padded kernels at the sweep's shapes: D = 12 at 270 x 50
    x_ws = torch.as_tensor(ws.x, dtype=torch.float32, device=dev)
    cfgs, w_init, _ = sweeps["default"]
    w, xs, ops = padded_sweep_inputs(simulator, fused_column, cfgs, w_init, x_ws)
    blk = xs[:, :32].contiguous()  # the first block of volleys
    c0 = cfgs[0]
    kw = dict(t_window=64, w_max=c0.neuron.w_max, wta_k=c0.wta.k,
              stabilize=c0.stdp.stabilizer == "half")
    b_ms = timer(lambda: fused_column.fused_block_padded(w, blk, ops, 32, **kw), 20)
    b_plain = timer(lambda: fused_column.fused_block_padded_plain(
        w, blk, ops, 32, **kw), 3, warmup=1)
    b_bytes, b_ops, b_ramp = block_bound(fused_column, w, blk, ops, kw)
    rows["sweep"] = dict(
        block=(b_ms, b_plain, *bound_ms(b_bytes, b_ops), b_bytes, b_ops))
    log(f"[time] sweep D={w.shape[0]} {w.shape[1]}x{w.shape[2]} fused_block "
        f"v_blk=32 ms={b_ms!r} plain_ms={b_plain!r} "
        f"bound_ms={rows['sweep']['block'][2]!r} ({rows['sweep']['block'][3]}; "
        f"{b_bytes} B, {b_ops} ops of the slope form; the ramp sum's {b_ramp} "
        f"ops, {bound_ms(b_bytes, b_ramp)[0]!r} ms) | {card}")
    # the batched fire on each launch of the integer-grid sweep, on that
    # launch's own inputs; the kernels line sums the sweep's launches
    # (the path's int32 times: the slope form), and on the same times as
    # f32 (the ramp sum)
    fire_sum = [0.0] * 7  # ms, plain, bound, bytes-ms, ops-ms, f32 ms, ramp ms
    shapes = []
    for (w, xs, ops), fire_kw in fire_calls:
        xs_f = xs.to(torch.float32)
        g_ms = timer(lambda: fused_column.fire_block_padded(w, xs, ops, **fire_kw), 20)
        g32_ms = timer(lambda: fused_column.fire_block_padded(w, xs_f, ops, **fire_kw),
                       20)
        g_plain = timer(lambda: fused_column.fire_block_padded_plain(
            w, xs, ops, **fire_kw), 2, warmup=1)
        g_bytes, g_ops, g_ramp = fire_bound(fused_column, w, xs, ops, fire_kw)
        g_bound, g_by = bound_ms(g_bytes, g_ops)
        ramp_bound = bound_ms(g_bytes, g_ramp)[0]
        d, n, p = xs.shape
        shapes.append(f"D={d} {p}x{w.shape[2]}")
        for i, v in enumerate((g_ms, g_plain, g_bound,
                               g_bytes / HBM_BYTES_PER_S * 1e3,
                               g_ops / F32_OPS_PER_S * 1e3, g32_ms, ramp_bound)):
            fire_sum[i] += v
        log(f"[time] grid sweep launch D={d} {p}x{w.shape[2]} fire_block N={n} "
            f"int32 times ms={g_ms!r}, f32 times ms={g32_ms!r}, plain_ms={g_plain!r} "
            f"bound_ms={g_bound!r} ({g_by}; {g_bytes} B, {g_ops} ops of the slope "
            f"form; the ramp sum's {g_ramp} ops, {ramp_bound!r} ms) | {card}")
    rows["sweep"]["fire"] = (
        fire_sum[0], fire_sum[1], fire_sum[2],
        "bytes" if fire_sum[3] >= fire_sum[4] else "operations")
    log(f"[time] grid sweep fire_block, {len(fire_calls)} launches "
        f"({' + '.join(shapes)}, N={n_ws}) int32 times ms={fire_sum[0]!r}, f32 "
        f"times ms={fire_sum[5]!r}, plain_ms={fire_sum[1]!r} bound_ms={fire_sum[2]!r} "
        f"({rows['sweep']['fire'][3]}, the slope form; the ramp sum's "
        f"{fire_sum[6]!r} ms) | {card}")

    # the float-weight fire on the DSE's on/off launch (D = 12 at 540 x
    # 50, N = 900, the trained weights and int32 volleys of phase 11)
    (w, xs, ops), float_kw = next(c for c in float_calls if c[0][1].shape[2] == 540)
    ff_ms = timer(lambda: fused_column.fire_float_padded(w, xs, ops, **float_kw), 20)
    ff_plain = timer(lambda: fused_column.fire_float_padded_plain(
        w, xs, ops, **float_kw), 2, warmup=1)
    ff_bytes, ff_ops = float_fire_bound(fused_column, w, xs, ops, float_kw["t_window"])
    rows["dse"] = dict(float=(ff_ms, ff_plain, *bound_ms(ff_bytes, ff_ops)))
    d, n, p = xs.shape
    log(f"[time] dse on/off launch D={d} {p}x{w.shape[2]} fire_float N={n} int32 "
        f"times ms={ff_ms!r} plain_ms={ff_plain!r} bound_ms={rows['dse']['float'][2]!r} "
        f"({rows['dse']['float'][3]}; {ff_bytes} B, {ff_ops} ops of the slope form) "
        f"{layout_name(build.FIRE_FLOAT, p, w.shape[2], float_kw['t_window'])} | {card}")

    # the STDP update: the ops path's first volley (270 x 25), then the
    # phase 6 shapes on their own inputs
    c_stdp = cfg_ws.stdp
    stdp_args = (c_stdp.mu_capture, c_stdp.mu_backoff, c_stdp.mu_search,
                 cfg_ws.neuron.w_max, cfg_ws.t_max, c_stdp.stabilizer == "half")
    # the path's times are int32, which the kernel reads as they are;
    # the same update on f32 times beside it
    w0s, x0s, y0s = stdp_path_inputs
    stdp_cases = [("ops path volley 0", w0s, x0s, y0s),
                  ("ops path volley 0, f32 times", w0s, x0s.float(), y0s.float())]
    for p, q in STDP_SHAPES:
        w, x, y = stdp_inputs(p, q, torch.int32, seed=p * 7 + q)
        stdp_cases.append(("", w.to(dev), x.to(dev), y.to(dev)))
    for label, w, x, y in stdp_cases:
        s_ms = timer(lambda: stdp_update.stdp_update(w, x, y, *stdp_args), 400)
        s_plain = timer(lambda: stdp_update.stdp_update_plain(w, x, y, *stdp_args), 200)
        p, q = w.shape
        s_bytes, s_ops = stdp_bound(p, q)
        s_bound, s_by = bound_ms(s_bytes, s_ops)
        if label == "ops path volley 0":
            rows["stdp"] = (s_ms, s_plain, s_bound, s_by, s_bytes, s_ops)
        log(f"[time] stdp_update {p}x{q} {label} ms={s_ms!r} plain_ms={s_plain!r} "
            f"bound_ms={s_bound!r} ({s_by}; {s_bytes} B, {s_ops} ops) | {card}")

    # the four fire kernels at 650 x 130, in their device-memory layout;
    # the flash kernel at the granite prefill shape
    rows["device_layout"] = time_device_layout(
        fused_column, rnl_response, timer, dev, card)
    flash_rows = time_flash(flash_lib, timer, dev, card)
    rows["flash"] = flash_rows[FLASH_TIMED[0][0]]
    time_flash_mla(flash_lib, timer, dev, card)
    rows["ssd"], err["ssd_scan"] = time_ssd(timer, dev, card)
    time_ssd(timer, dev, card, SSD_TIMED_RAG2K, "granite-4.0-h-small")
    rows["conv"] = time_conv(timer, dev, card)
    rows["step"] = time_ssm_step(timer, dev, card, get_arch)
    log(f"[serve] {LM_ARCH} prefill ms={lm['prefill_ms']!r} decode ms/token="
        f"{lm['decode_ms']!r} peak device memory {lm['peak']} B | {card}")

    # 18 — TNN serving at full width, on the fire_block and fused_block kernels
    tnn = tnn_serving(build, fused_column, simulator, ucr, dev, card, timer)
    log(f"[serve_tnn] {tnn['rps']!r} requests/s, p50 {tnn['p50_ms']!r} ms, p99 "
        f"{tnn['p99_ms']!r} ms, batch {tnn['batch_ms']!r} ms, re-fit "
        f"{tnn['refit_ms']!r} ms (host clock) | {card}")

    # 20 — the paper's Table II on the card: k-means, the TNN column, DTCR
    table2(build, simulator, column, ucr, dev, card)

    # 22 — the MoE, SSM, hybrid, audio and VLM families on the card
    families = lm_families(T, serve_lib, moe_lib, get_arch, build, dev, card)

    # 23 — LM training on the card
    train = lm_training(T, get_arch, build, dev, card, timer)

    # 24 — the dry run, against a real step on the card and at production scale
    launches0 = {k.name: k.launches for k in build.KERNELS}
    dry_run(T, get_arch, dev, card, train["step_ms"])
    assert {k.name: k.launches for k in build.KERNELS} == launches0  # no kernel on this path

    # 19 — the kernels line; launches from each kernel's own path
    wsr = rows["WordSynonyms"]
    path_launches = dict(launches, fused_block=sweep_launches["fused_block"],
                         fire_block=sweep_launches["fire_block"],
                         fire_float=dse_launches["fire_float"],
                         stdp_update=ops_launches["stdp_update"],
                         flash_attention=lm["launches"])
    entries = []
    for k, r, shape in (
        (build.FUSED_STEP, wsr["fit"],
         f"D=1 270x25 t_max=64: the whole fit, N={n_ws} x {EPOCHS} epochs, in one "
         f"launch, no trace; plain_ms: the plain fold over the same fit"),
        (build.RNL_FIRE, wsr["rnl"], f"B={n_ws} 270x25 t_max=64"),
        (build.FUSED_BLOCK, rows["sweep"]["block"], "D=12 270x50 v_blk=32 t_window=64"),
        (build.FIRE_BLOCK, rows["sweep"]["fire"],
         f"sum of the grid sweep's launches: {' + '.join(shapes)}, "
         f"N={n_ws} t_window=64"),
        (build.FIRE_FLOAT, rows["dse"]["float"],
         f"the DSE's on/off launch: D=12 540x50 N={n_ws} t_window=64, trained "
         f"float weights"),
        (build.STDP_UPDATE, rows["stdp"], "270x25 t_max=64, the ops path's volley 0"),
    ):
        entries.append({
            "name": k.name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces.split()[0], "launches": path_launches[k.name],
            "max_abs_err": err[k.name], "ms": r[0], "plain_ms": r[1],
            "bound_ms": r[2], "bound_by": r[3], "library_ms": None,
            "shape": shape,
        })
    k = build.FLASH_ATTENTION
    entries.append({
        "name": k.name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{k.source}",
        "replaces": k.replaces.split()[0], "launches": path_launches[k.name],
        "max_abs_err": err[k.name], "ms": rows["flash"][0],
        "plain_ms": rows["flash"][1], "bound_ms": rows["flash"][2],
        "bound_by": rows["flash"][3], "library_ms": rows["flash"][4],
        "shape": f"B={LM_BATCH} S={LM_PROMPT} Hq=32 Hkv=8 d=128 bf16 causal "
                 f"(one layer of the {LM_ARCH} prefill)",
    })
    k = build.SSD_SCAN
    entries.append({
        "name": k.name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{k.source}",
        "replaces": None, "launches": families["zamba2-7b"]["ssd_launches"],
        "max_abs_err": err[k.name], "ms": rows["ssd"][0], "plain_ms": rows["ssd"][1],
        "bound_ms": rows["ssd"][2], "bound_by": rows["ssd"][3], "library_ms": None,
        "shape": "B={} L={} H={} G={} N={} dh={} chunk={} bf16 (one layer of the "
                 "zamba2-7b-instruct.docs4k prefill); launches: a zamba2-7b "
                 "prefill's".format(*SSD_TIMED),
    })
    k = build.CAUSAL_CONV
    entries.append({
        "name": k.name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{k.source}",
        "replaces": None, "launches": families["zamba2-7b"]["conv_launches"],
        "max_abs_err": err[k.name], "ms": rows["conv"][0], "plain_ms": rows["conv"][1],
        "bound_ms": rows["conv"][2], "bound_by": rows["conv"][3], "library_ms": None,
        "shape": "B={} L={} C={} bf16 with a bias and a state, u the in_proj rows' "
                 "x | B | C columns (one layer of the zamba2-7b-instruct.docs4k "
                 "prefill); launches: a zamba2-7b prefill's".format(
                     CONV_TIMED[0], CONV_TIMED[1], CONV_TIMED[2] + 2 * CONV_TIMED[3]),
    })
    k = build.SSM_STEP
    ms, plain, b_ms, by, token_ms, proj_ms, max_abs = rows["step"]["zamba2-7b-instruct"]
    entries.append({
        "name": k.name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{k.source}",
        "replaces": None, "launches": families["zamba2-7b"]["step_launches"],
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain - proj_ms,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
        "shape": f"B={STEP_BATCH} H=112 G=2 N=64 dh=64 bf16 (one mamba layer of the "
                 f"zamba2-7b-instruct.docs4k decode step, two launches); plain_ms: "
                 f"_one_token_plain less its out_proj product; launches: a zamba2-7b "
                 f"serving run's {LM_TOKENS - 1} decode steps",
    })
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
