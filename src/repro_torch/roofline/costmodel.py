"""Device-calibrated cost model of the padded fused scans' schedule.

The port's counterpart of the JAX package's ``roofline/costmodel.py``.
Every schedule knob of a padded scan (the volley block ``v_blk``, the
envelope waste cap, the design-axis shard count) comes from one policy:

* **DeviceProfile**: the calibration record: peak f32 FLOP/s, streaming
  bandwidth, link bandwidth (0 on one card: there is no link), the
  per-launch overhead, the fixed cost of one more envelope bucket (its
  launch sequence and its host pass: what sharing an envelope saves,
  in place of the JAX package's per-envelope compile, which a PyTorch
  path never pays), the shared memory one thread block may use, and
  ``fused_eff``, predicted over measured on one real ``fused_block``
  launch.  ``PROFILES`` holds named records; none is ever active
  implicitly.
* **calibrate()** probes the card with CUDA events, activates the record
  and keeps it beside the built kernels (``kernels/build.py``
  ``BUILD_DIR``, which git ignores).  Importing the library never
  probes; ``load_profile`` activates a matching record from disk.
* **analytic_volley_cost** counts the work the lowering does: for
  ``'cuda'`` the volley-block kernel's slope form, with the weights on
  chip across a block, for ``'reference'`` the plain version's dense
  ramp.
* **choose_plan** predicts warm seconds per volley for each candidate
  block, keeps the ``'cuda'`` candidates that ``fused_block`` folds in
  one launch (its own ``_smem_bytes`` decides), and returns the fastest,
  ties within ``WARM_TIE_TOL`` going to the largest block.  Without an
  active profile it returns the constants plan, exactly the schedule of
  an uncalibrated host.

A plan changes the blocking and the bucketing, never a result: every
block size and every envelope gives the same weights and ids.

What has no counterpart: ``xla_volley_cost`` and the ``envelope_cost``
disk store (there is no XLA cost analysis; the closed form is the only
cost), ``trace_unroll`` (nothing is traced or unrolled), and ``t_blk``
with ``_candidate_t_blks`` (no CUDA kernel of the port tiles time).

    python -m repro_torch.roofline.costmodel [--force]

calibrates the card (or loads the persisted record) and prints it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import time
from typing import Callable, Optional

import torch

CALIBRATION_FILE = "calibration.json"
CALIBRATION_VERSION = 1

# The hand-tuned constants of the JAX package, unchanged: volleys folded
# per block (the kernel lowering folds a block in one launch; the
# reference lowering keeps blocks small), and the envelope waste cap.
CONST_V_BLK_REFERENCE = 8
CONST_V_BLK_KERNEL = 32
CONST_WASTE_CAP = 4.0

# Two candidates whose predicted warm times differ by less than this are
# a tie: the prediction's resolution, not a real difference.
WARM_TIE_TOL = 0.05

# Shared memory one thread block may use on an H100 (227 KB): a copy of
# ``kernels/build.py``'s ``MAX_SMEM_BYTES``, so that importing this module
# imports nothing of the package (the kernels package imports the
# backend, which imports this module).
H100_SMEM_BYTES = 232448


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One calibration record of a host and its card.

    ``peak_flops`` and ``hbm_bw`` are the roofline peaks (f32 FLOP/s,
    B/s), ``link_bw`` the bandwidth between cards (0 with one card).
    ``dispatch_s`` is the overhead of one launch (what a larger block
    amortizes), ``bucket_s`` the fixed cost of one more envelope bucket
    (what sharing an envelope saves), ``footprint_bytes`` the shared
    memory one thread block may use.  ``fused_eff`` scales the roofline
    to a measured volley block.
    """

    name: str
    platform: str           # 'cuda' | 'cpu'
    device_kind: str        # torch.cuda.get_device_name(0), or 'cpu'
    peak_flops: float
    hbm_bw: float
    link_bw: float
    dispatch_s: float
    bucket_s: float
    footprint_bytes: float
    n_devices: int = 1
    calibrated: bool = False
    fused_eff: float = 1.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["version"] = CALIBRATION_VERSION
        return d

    @staticmethod
    def from_json(d: dict) -> "DeviceProfile":
        return DeviceProfile(**{k: v for k, v in d.items() if k != "version"})


# Named records, never active implicitly.  'host-cpu' is the JAX
# package's generic CPU (its compile cost in the bucket slot).  'h100-sxm'
# carries the data-sheet peaks of the NVIDIA H100 80GB HBM3 (SXM, 700 W):
# 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s HBM3; its launch and
# bucket costs are nominal round figures until ``calibrate`` measures them.
PROFILES: dict[str, DeviceProfile] = {
    "host-cpu": DeviceProfile(
        name="host-cpu", platform="cpu", device_kind="cpu",
        peak_flops=5e10, hbm_bw=1e10, link_bw=1e10,
        dispatch_s=3e-5, bucket_s=0.05, footprint_bytes=32 * 2**20,
    ),
    "h100-sxm": DeviceProfile(
        name="h100-sxm", platform="cuda", device_kind="NVIDIA H100 80GB HBM3",
        peak_flops=67e12, hbm_bw=3.35e12, link_bw=0.0,
        dispatch_s=1e-5, bucket_s=1e-3, footprint_bytes=float(H100_SMEM_BYTES),
    ),
}


# ------------------------------------------------------------ activation
# The active profile is process state, set explicitly (calibrate /
# load_profile / set_profile): policy functions read it, never fill it.
_ACTIVE: Optional[DeviceProfile] = None


def profile() -> Optional[DeviceProfile]:
    """The active calibration record, or None (the constants plan)."""
    return _ACTIVE


def set_profile(p: Optional[DeviceProfile]) -> Optional[DeviceProfile]:
    """Activate ``p`` (None deactivates); returns the previous one."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = p
    return prev


@contextlib.contextmanager
def override(p: Optional[DeviceProfile]):
    """Activate ``p`` for a block (None forces the constants plan)."""
    prev = set_profile(p)
    try:
        yield
    finally:
        set_profile(prev)


# ----------------------------------------------------------- persistence
def calibration_path() -> str:
    """Where the record persists: beside the built kernels."""
    from repro_torch.kernels.build import BUILD_DIR

    return str(BUILD_DIR / CALIBRATION_FILE)


def host_identity() -> tuple[str, str, int]:
    """(platform, device kind, device count) of this host."""
    if torch.cuda.is_available():
        return "cuda", torch.cuda.get_device_name(0), torch.cuda.device_count()
    return "cpu", "cpu", 1


def save_profile(p: DeviceProfile, path: Optional[str] = None) -> str:
    """Persist ``p`` (write, then rename into place); returns the path."""
    path = path or calibration_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(p.to_json(), f, indent=2)
    os.replace(tmp, path)
    return path


def load_profile(path: Optional[str] = None) -> Optional[DeviceProfile]:
    """Load and ACTIVATE a persisted record if one exists and was taken
    on this host (same platform, card and card count, same version); a
    record of other silicon is ignored.  Returns it, or None."""
    path = path or calibration_path()
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            d = json.load(f)
        if d.get("version") != CALIBRATION_VERSION:
            return None
        p = DeviceProfile.from_json(d)
    except (OSError, ValueError, TypeError):
        return None
    if (p.platform, p.device_kind, p.n_devices) != host_identity():
        return None
    set_profile(p)
    return p


# ------------------------------------------------------------ probe suite
def _event_ms(fn: Callable[[], object], reps: int = 5) -> float:
    """Least device time of one call of ``fn`` between two CUDA events,
    after a warm-up call."""
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


def _probe_peak_flops(dev: torch.device) -> float:
    """f32 FLOP/s of a square product with TF32 off."""
    n = 4096
    a = torch.randn((n, n), device=dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms = _event_ms(lambda: a @ a)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return 2.0 * n**3 / (ms * 1e-3)


def _probe_hbm_bw(dev: torch.device) -> float:
    """Streaming bandwidth of an elementwise add over 256 MiB in and 256
    MiB out: more than 4x the card's L2, so the reads come from HBM."""
    props = torch.cuda.get_device_properties(dev)
    n = max(64 * 2**20, int(props.L2_cache_size))  # f32: 4 n B >= 4x L2
    x = torch.zeros(n, device=dev)
    y = torch.empty_like(x)
    ms = _event_ms(lambda: torch.add(x, 1.0, out=y))
    return 2.0 * 4.0 * n / (ms * 1e-3)


def _probe_block(dev: torch.device, v_blk: int):
    """A small real volley block: D = 2, 64 x 8 envelope, t_window 64."""
    from repro_torch.kernels import fused_column

    gen = torch.Generator().manual_seed(0)
    d, p, q, tw = 2, 64, 8, 64
    w = torch.randint(0, 8, (d, p, q), generator=gen).float().to(dev)
    xs = torch.randint(0, tw, (d, v_blk, p), generator=gen).float().to(dev)
    ops = fused_column.design_operands(
        [p / 3.0] * d, [tw] * d, [q - 2] * d, 1.0, 1.0, 1.0, device=dev
    )
    kw = dict(t_window=tw, w_max=7, wta_k=1, stabilize=False)

    def launch():
        return fused_column.fused_block_padded(w, xs, ops, v_blk, **kw)

    return (d, p, q, tw), launch


def _probe_dispatch_s(dev: torch.device) -> float:
    """Host seconds per launch of the volley-block wrapper on a one-volley
    block, back to back: the overhead a larger block amortizes."""
    _, launch = _probe_block(dev, 1)
    launch()
    torch.cuda.synchronize(dev)
    best = math.inf
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(50):
            launch()
        torch.cuda.synchronize(dev)
        best = min(best, (time.perf_counter() - t0) / 50)
    return best


def _probe_bucket_s(dev: torch.device) -> float:
    """Host seconds of one more envelope bucket: one tiny design's padded
    fit and assignment, host pass and launches, end to end."""
    import numpy as np

    from repro_torch.core import simulator
    from repro_torch.core.types import ColumnConfig, TIME_DTYPE

    cfg = ColumnConfig(p=16, q=2, t_max=16)
    cfg = cfg.with_threshold(simulator.suggest_threshold(cfg))
    gen = torch.Generator().manual_seed(0)
    enc = [torch.randint(0, 16, (2, 16), generator=gen).to(dev, TIME_DTYPE)]
    w0 = [np.full((16, 2), 3.0, np.float32)]
    best = math.inf
    for _ in range(6):
        t0 = time.perf_counter()
        simulator._sweep_bucket([cfg], [0], (16, 2, 16), enc, w0, 1, "cuda")
        best = min(best, time.perf_counter() - t0)
    return best


def _probe_fused_eff(p: DeviceProfile, dev: torch.device) -> float:
    """Predicted over measured device time of one real volley-block
    launch (D = 2, 64 x 8, 32 volleys).  Raises on any failure: a kernel
    that does not build or launch on the card is a fault."""
    v_blk = 32
    (d, pp, qq, tw), launch = _probe_block(dev, v_blk)
    measured = _event_ms(launch, reps=10) * 1e-3 / v_blk
    flops, byts = analytic_volley_cost(d, pp, qq, tw, "cuda", v_blk)
    predicted = max(flops / p.peak_flops, byts / p.hbm_bw)
    return predicted / measured


def calibrate(force: bool = False, persist: bool = True) -> DeviceProfile:
    """Probe the card, ACTIVATE the record and (with ``persist``) keep it
    beside the built kernels.  An already active calibrated record is
    returned as it is unless ``force``.  Needs a CUDA card; every probe
    failure raises."""
    from repro_torch.core import backend as backend_lib
    from repro_torch.kernels.build import MAX_SMEM_BYTES

    if _ACTIVE is not None and _ACTIVE.calibrated and not force:
        return _ACTIVE
    dev = backend_lib.default_device(None)
    platform, kind, count = host_identity()
    with override(None):
        p = DeviceProfile(
            name=f"calibrated-{platform}",
            platform=platform,
            device_kind=kind,
            peak_flops=_probe_peak_flops(dev),
            hbm_bw=_probe_hbm_bw(dev),
            link_bw=0.0,  # not probed: the port runs on one card
            dispatch_s=_probe_dispatch_s(dev),
            bucket_s=_probe_bucket_s(dev),
            footprint_bytes=float(MAX_SMEM_BYTES),
            n_devices=count,
            calibrated=True,
        )
        p = dataclasses.replace(p, fused_eff=_probe_fused_eff(p, dev))
    for field in ("peak_flops", "hbm_bw", "dispatch_s", "bucket_s", "fused_eff"):
        v = getattr(p, field)
        if not (math.isfinite(v) and v > 0):
            raise RuntimeError(f"calibration probe {field} gave {v!r}")
    set_profile(p)
    if persist:
        save_profile(p)
    return p


def load_or_calibrate() -> DeviceProfile:
    """Reuse a persisted record of this host, else probe (and persist)."""
    return load_profile() or calibrate()


# --------------------------------------------------------- envelope cost
@functools.lru_cache(maxsize=256)
def analytic_volley_cost(
    d: int, p_pad: int, q_pad: int, t_window: int,
    lowering: str = "cuda", v_blk: int = 1,
) -> tuple[float, float]:
    """Closed-form (operations, bytes) per volley of a padded scan.

    ``'cuda'``: the volley-block kernel's slope form, the count
    ``chip_smoke.py``'s ``block_bound`` makes on real inputs, at every
    synapse and neuron live: about 2 adds per synapse for the scatter, 2
    per neuron per cycle of the scan, about 10 per synapse for STDP; the
    weights stay on chip across a block, so a block of ``v_blk`` volleys
    moves ``4 (2 d p q + d v_blk p + 6 d)`` bytes and the bytes per volley
    fall with ``v_blk``.

    ``'reference'``: the plain version's dense ramp: a min and an add per
    synapse per cycle and the same STDP; the weights in and out, the
    volley, the ramp, the [p, q, t] contributions written and read and
    the potential, every volley.
    """
    d, p, q, t = int(d), int(p_pad), int(q_pad), int(t_window)
    if lowering == "cuda":
        flops = d * (12.0 * p * q + 2.0 * q * t)
        v = max(int(v_blk), 1)
        byts = 4.0 * (2.0 * d * p * q + d * v * p + 6.0 * d) / v
        return flops, byts
    flops = d * (2.0 * p * q * t + 10.0 * p * q)
    byts = 4.0 * d * (2.0 * p * q + p + p * t + 2.0 * p * q * t + q * t)
    return flops, byts


# -------------------------------------------------------- plan + chooser
@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """One schedule decision for a padded fused scan, with the prediction
    that chose it, so results can record why their schedule was what it
    was.  Frozen and hashable.

    Contract (``plan_is_valid``): ``1 <= v_blk <= n_volleys``; ``shards``
    divides ``d``; ``waste_cap >= 1``.  Every legal plan gives the same
    result.
    """

    kind: str               # 'fit' | 'assign'
    lowering: str
    d: int
    n_volleys: int
    v_blk: int
    shards: int
    waste_cap: float
    predicted_step_s: float  # predicted warm seconds per volley (0: constants)
    source: str              # 'costmodel' | 'constants'
    profile: str             # the profile's name ('' for constants)

    def meta(self) -> dict:
        """JSON-ready record of the plan."""
        return {
            "kind": self.kind,
            "lowering": self.lowering,
            "v_blk": self.v_blk,
            "shards": self.shards,
            "waste_cap": self.waste_cap,
            "predicted_step_us": self.predicted_step_s * 1e6,
            "source": self.source,
            "profile": self.profile,
        }


def const_v_blk(lowering: str, n_volleys: int, d: Optional[int] = None) -> int:
    """The constants block policy: 32 volleys per block for the kernel
    lowering, 8 for 'reference' (capped at ``max(2, 2 d)`` when the
    design-axis length ``d`` is known), never more than the stream."""
    base = (
        CONST_V_BLK_REFERENCE if lowering == "reference"
        else CONST_V_BLK_KERNEL
    )
    if d is not None and lowering == "reference":
        base = min(base, max(2, 2 * int(d)))
    return max(1, min(base, int(n_volleys)))


def constants_plan(
    kind: str, lowering: str, d: int, n_volleys: int, shards: int = 1
) -> ExecutionPlan:
    """The plan of an uncalibrated host: the constants above."""
    return ExecutionPlan(
        kind=kind, lowering=lowering, d=int(d),
        n_volleys=max(int(n_volleys), 1),
        v_blk=const_v_blk(lowering, n_volleys, d if kind == "fit" else None),
        shards=int(shards),
        waste_cap=CONST_WASTE_CAP,
        predicted_step_s=0.0,
        source="constants",
        profile="",
    )


def kernel_fits(p: int, q: int, v_blk: int, t_window: int) -> bool:
    """Whether ``fused_block_padded`` folds a block of ``v_blk`` volleys of
    a p x q envelope in ONE launch: its own ``_smem_bytes`` decides
    (``fused_column.block_sub_launches``).  Builds the kernels."""
    from repro_torch.kernels import fused_column

    return len(fused_column.block_sub_launches(p, q, v_blk, v_blk, t_window)) == 1


def _candidate_v_blks(lowering: str, n_volleys: int) -> list[int]:
    """Powers of two from 2 up to the lowering's constants base (32
    ``'cuda'``, 8 ``'reference'``), clamped to the stream."""
    cap = CONST_V_BLK_REFERENCE if lowering == "reference" else CONST_V_BLK_KERNEL
    out = []
    v = 2
    while v <= min(n_volleys, cap):
        out.append(v)
        v *= 2
    return out or [max(1, min(int(n_volleys), cap))]


def predict_step_s(
    prof: DeviceProfile, lowering: str,
    d: int, p_pad: int, q_pad: int, t_window: int,
    v_blk: int, shards: int = 1,
) -> float:
    """Predicted warm seconds per volley under a candidate block:

        max(ops/peak, bytes/bw) / fused_eff / shards   the scaled roofline
        + dispatch_s * shards / v_blk                  launches, amortized
    """
    flops, byts = analytic_volley_cost(d, p_pad, q_pad, t_window, lowering, v_blk)
    roofline_s = max(flops / prof.peak_flops, byts / prof.hbm_bw)
    roofline_s /= max(prof.fused_eff, 1e-12)
    return roofline_s / max(shards, 1) + prof.dispatch_s * shards / max(v_blk, 1)


@functools.lru_cache(maxsize=512)
def _choose_plan_cached(
    prof: DeviceProfile, kind: str, lowering: str,
    d: int, p_pad: int, q_pad: int, t_window: int,
    n_volleys: int, epochs: int,
    fits: Optional[Callable[[int, int, int, int], bool]],
) -> ExecutionPlan:
    cands = []
    for v_blk in _candidate_v_blks(lowering, n_volleys):
        # the plain version folds one volley at a time: no block size
        # grows its transients.  A kernel block must fit in one launch.
        ok = lowering != "cuda" or (fits or kernel_fits)(
            p_pad, q_pad, v_blk, t_window
        )
        s = predict_step_s(prof, lowering, d, p_pad, q_pad, t_window, v_blk)
        cands.append((ok, s, v_blk))
    # admissible candidates first (all of them limp through if none is);
    # then the fastest, ties within WARM_TIE_TOL to the largest block
    if any(ok for ok, _, _ in cands):
        cands = [c for c in cands if c[0]]
    best_s = min(s for _, s, _ in cands)
    _, s, v_blk = max(
        (c for c in cands if c[1] <= best_s * (1.0 + WARM_TIE_TOL)),
        key=lambda c: c[2],
    )
    return ExecutionPlan(
        kind=kind, lowering=lowering, d=d, n_volleys=n_volleys,
        v_blk=v_blk, shards=1,
        waste_cap=choose_waste_cap(prof, d, p_pad, q_pad, t_window,
                                   n_volleys, epochs),
        predicted_step_s=s, source="costmodel", profile=prof.name,
    )


def choose_plan(
    kind: str, lowering: str, d: int, p_pad: int, q_pad: int, t_window: int,
    n_volleys: int, epochs: int = 1, *, prof: Optional[DeviceProfile] = None,
    fits: Optional[Callable[[int, int, int, int], bool]] = None,
) -> ExecutionPlan:
    """The policy front door: an ``ExecutionPlan`` for one padded scan.

    With an active (or passed) profile the predicted-fastest admissible
    candidate wins (``source='costmodel'``); without one the constants
    come back unchanged (``source='constants'``).  ``fits(p, q, v_blk,
    t_window)`` decides whether a ``'cuda'`` block folds in one launch
    (None: ``kernel_fits``, the kernel's own formula).  Deterministic for
    fixed inputs.
    """
    prof = prof if prof is not None else profile()
    n_volleys = max(int(n_volleys), 1)
    if prof is None:
        return constants_plan(kind, lowering, d, n_volleys)
    return _choose_plan_cached(
        prof, kind, lowering, int(d), int(p_pad), int(q_pad), int(t_window),
        n_volleys, int(max(epochs, 1)), fits,
    )


def choose_waste_cap(
    prof: Optional[DeviceProfile] = None,
    d: int = 1, p_pad: int = 1, q_pad: int = 1, t_window: int = 1,
    n_volleys: int = 0, epochs: int = 1,
) -> float:
    """Envelope waste cap from the roofline: padding waste recurs every
    volley (cost ~ cap x volley seconds x total volleys), while sharing an
    envelope saves one bucket's fixed cost.  They break even at ``1 +
    bucket_s / (volley_s * total_volleys)``, clamped to [1.5, 8].  The
    constants' 4.0 without a profile or a stream length.  The volley is
    costed in the lowering of the profile's platform at its constants
    block."""
    prof = prof if prof is not None else profile()
    total = max(int(n_volleys), 0) * max(int(epochs), 1)
    if prof is None or total <= 0:
        return CONST_WASTE_CAP
    lowering = "cuda" if prof.platform == "cuda" else "reference"
    flops, byts = analytic_volley_cost(
        max(d, 1), max(p_pad, 1), max(q_pad, 1), max(t_window, 1), lowering,
        const_v_blk(lowering, total),
    )
    volley_s = max(flops / prof.peak_flops, byts / prof.hbm_bw, 1e-12)
    volley_s /= max(prof.fused_eff, 1e-12)
    cap = 1.0 + prof.bucket_s / (volley_s * total)
    return float(min(max(cap, 1.5), 8.0))


def choose_shards(d: int, volume: Optional[float] = None) -> int:
    """Design-axis shard count: 1.  The port runs a sweep on one card."""
    return 1


def plan_is_valid(plan: ExecutionPlan) -> bool:
    """The plan contract as one predicate."""
    return (
        1 <= plan.v_blk <= max(plan.n_volleys, 1)
        and plan.shards >= 1
        and plan.d % plan.shards == 0
        and plan.waste_cap >= 1.0
    )


def main(argv=None) -> int:
    """CLI: load this card's persisted record, or calibrate and persist
    one, and print it."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--force", action="store_true",
                    help="probe again even if a persisted record matches")
    args = ap.parse_args(argv)
    p = None if args.force else load_profile()
    if p is None:
        p = calibrate(force=True)
    print(json.dumps(p.to_json(), indent=2))
    print(f"persisted at {calibration_path()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
