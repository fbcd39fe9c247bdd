"""Design-space exploration: bucketed sweep -> silicon forecast -> Pareto.

This is the paper's headline loop closed end to end: grid or random
search over (q, t_max, threshold, encoder) runs through the functional
simulator's envelope-bucketed design sweep
(``simulator.cluster_time_series_many``, the volley-block kernel on the
card), each design's clustering quality is paired with forecasted
post-layout area/leakage from its synapse count
(``repro_torch.hwgen.forecast`` — the TNN7 regression by default), and the
result is a Pareto frontier of Rand index vs silicon cost — no hardware
flow run required.

Exploration is built for *long* runs: evaluations are fault-isolated by
default (one degenerate candidate is quarantined as an ``EvalFailure``
record in ``meta['failures']`` instead of aborting the sweep), per-bucket
wall times are watched for stalls (``distributed.straggler.StepMonitor``),
and passing ``journal=`` makes every completed bucket durable so
``resume=True`` after a kill re-evaluates only the missing candidates —
bit-identical to an uninterrupted run.

The port's counterpart of the JAX package's ``dse/explore.py``, with the
same API and semantics except:

* initial weights come from ``initial_weights`` (a ``torch.Generator``
  seeded from the run's seed and the candidate's index), not from the
  JAX package's generator; the journal header names that initializer,
  so a journal of the JAX package is refused on resume;
* there is no persistent compile cache, every schedule is the constants
  plan, and ``meta['shards']`` is 1 (one card).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import backend as backend_lib
from repro_torch.core import column as column_lib
from repro_torch.core import simulator
from repro_torch.core.types import ColumnConfig
from repro_torch.distributed.straggler import StepMonitor
from repro_torch.dse import journal as journal_lib
from repro_torch.dse.pareto import DesignPoint, pareto_front
from repro_torch.dse.space import DesignSpace, candidate_config

# Names ``initial_weights`` in the journal header: a journal whose header
# names another initializer (the JAX package's has none) is refused.
INIT = "repro_torch.dse.initial_weights/torch.Generator(sha256(seed,index))"


def initial_weights(seed: int, index: int, cfg: ColumnConfig) -> np.ndarray:
    """Candidate ``index``'s initial weights [p, q] float32, uniform over
    [0, w_max], from a CPU ``torch.Generator`` seeded by (seed, index)
    only: results are invariant to grouping, bucketing and resume
    subsets.  (JAX's ``fold_in`` keys cannot be reproduced in PyTorch.)"""
    h = hashlib.sha256(f"{int(seed)}/{int(index)}".encode()).digest()
    gen = torch.Generator().manual_seed(int.from_bytes(h[:8], "little") >> 1)
    return column_lib.init_params(cfg, gen, "cpu")["w"].numpy()


@dataclasses.dataclass
class DSEResult:
    """Outcome of one exploration run.

    ``points`` holds every *scored* candidate in explore order (a
    quarantined candidate has no point); ``pareto`` the nondominated
    subset (Rand index up, forecasted area and leakage down),
    cheapest-area first.  ``meta`` records how the sweep executed,
    per encoder group where applicable:

      * ``'buckets'`` / ``'lowering'`` — dicts keyed by encoder: the
        bucket count and the comma-joined lowerings that actually ran
        for that group (every group, not just the last one).
      * ``'failures'`` — one dict per quarantined candidate (index,
        encoder, stage, error, lowerings attempted, retries); empty on
        a clean run.  ``'quarantined'`` is its length.
      * ``'retries'`` / ``'fallbacks'`` — total failed ladder-rung
        attempts across the run, and how many scored designs ran on a
        degraded lowering.
      * ``'stalls'`` — straggler events (bucket wall-time outliers)
        flagged by the step monitor.
      * ``'resumed'`` — candidates restored from the journal instead of
        re-evaluated (0 without ``resume=True``).
    """

    points: list[DesignPoint]
    pareto: list[DesignPoint]
    seconds: float
    meta: dict

    def best(self) -> DesignPoint:
        """Highest Rand index per forecasted area — the NSPU design
        objective the example sweeps optimize.

        Raises a diagnostic ``ValueError`` when the frontier is empty:
        either nothing was scored (all candidates quarantined — the
        error says how many and points at ``meta['failures']``) or the
        stream was unlabeled (NaN Rand indices rank nothing).
        """
        if not self.pareto:
            quarantined = len(self.meta.get("failures", ()))
            detail = (
                f"{quarantined} candidate(s) quarantined — see "
                "DSEResult.meta['failures']"
                if quarantined
                else "was the stream labeled? NaN Rand indices rank nothing"
            )
            raise ValueError(
                f"empty Pareto frontier: {len(self.points)} of "
                f"{len(self.points) + quarantined} candidate(s) scored; "
                + detail
            )
        return max(self.pareto, key=lambda p: p.rand_index / p.area_um2)


def explore(
    series: np.ndarray,
    labels: Optional[np.ndarray],
    space: DesignSpace,
    epochs: int = 4,
    search: str = "grid",
    budget: Optional[int] = None,
    seed: int = 0,
    forecaster=None,
    waste_cap: Optional[float] = None,
    max_bucket: Optional[int] = None,
    on_error: str = "isolate",
    journal: Union[str, journal_lib.Journal, None] = None,
    resume: bool = False,
    monitor: Optional[StepMonitor] = None,
    device=None,
) -> DSEResult:
    """Explore a column design space over one stream, silicon-forecasted.

    Args:
      series: [N, L] real-valued stream (N >= 1; an empty stream raises).
      labels: [N] ground-truth classes; required — the Pareto frontier
        ranks on the Rand index, which needs labels.
      space: the axes to search (see ``DesignSpace``).
      epochs: STDP passes per design.
      search: 'grid' (the full cross product) or 'random' (``budget``
        uniform draws from it, deterministic per ``seed``).
      budget: candidate cap; required for 'random', optional for 'grid'
        (truncates the deterministic grid order).
      seed: feeds both candidate sampling and per-design weight init
        (``initial_weights``), so equal seeds reproduce the exploration
        exactly.  Init weights are keyed by (seed, candidate index) —
        never by sweep position — so results are invariant to grouping,
        bucketing, and resume subsets.
      forecaster: any object with ``area_um2(synapses)`` /
        ``leakage_uw(synapses)`` — ``hwgen.forecast.PaperForecaster``
        (TNN7 regression) by default; pass a refit
        ``hwgen.forecast.Forecaster`` to use an accumulated design
        database instead.
      waste_cap / max_bucket: envelope-bucketing knobs forwarded to
        ``cluster_time_series_many`` (None defers to central policy).
      on_error: 'isolate' (default) quarantines failing candidates as
        ``EvalFailure`` records in ``meta['failures']`` and keeps
        sweeping; 'raise' propagates the first failure (debugging).
      journal: path (or ``Journal``) to an append-only evaluation
        journal; every completed bucket is published atomically, so a
        killed run loses at most one bucket.  An existing journal
        requires ``resume=True`` and a header of this package's
        initializer (``INIT``).
      resume: skip candidates already in the journal (scored *and*
        quarantined); the resumed run's frontier is bit-identical to an
        uninterrupted one.
      monitor: optional ``StepMonitor`` override for stall detection
        (a fresh one per run by default); its events land in
        ``meta['stalls']``.
      device: where the sweep runs; None means the card (raises without
        one); ``'cpu'`` runs the kernels' plain versions.

    Candidates sharing an encoder sweep together (the encoder pins the
    input width); within each encoder group the sweep is envelope-bucketed
    by the central backend policy.

    Returns a ``DSEResult`` whose ``pareto`` pairs each surviving design's
    Rand index with its forecasted area/leakage; every point's
    ``params['w']`` is a float32 numpy array.
    """
    with obs.span("dse.explore"):
        return _explore(
            series, labels, space, epochs, search, budget, seed, forecaster,
            waste_cap, max_bucket, on_error, journal, resume, monitor, device,
        )


def _explore(
    series, labels, space, epochs, search, budget, seed, forecaster,
    waste_cap, max_bucket, on_error, journal, resume, monitor, device,
) -> DSEResult:
    t_prepare = obs.now()
    if labels is None:
        raise ValueError(
            "explore ranks designs on the Rand index; labels are required"
        )
    device = backend_lib.default_device(device)
    if forecaster is None:
        from repro_torch.hwgen.forecast import PaperForecaster

        forecaster = PaperForecaster()

    if search == "grid":
        candidates = space.grid()
        if budget is not None:
            candidates = candidates[: int(budget)]
    elif search == "random":
        if budget is None:
            raise ValueError("search='random' needs a candidate budget")
        candidates = space.sample(budget, seed=seed)
    else:
        raise ValueError(f"unknown search: {search!r} (grid | random)")

    series = np.asarray(series)
    n_cand = len(candidates)
    cfgs_all = [candidate_config(c, series.shape[1]) for c in candidates]
    fps = [
        journal_lib.candidate_fingerprint(cfg, c.encoder, seed, epochs)
        for cfg, c in zip(cfgs_all, candidates)
    ]

    jr = journal
    if jr is not None and not isinstance(jr, journal_lib.Journal):
        jr = journal_lib.Journal(jr)
    restored: dict = {}
    if jr is not None:
        restored = jr.begin(
            {"seed": int(seed), "epochs": int(epochs), "search": search,
             "init": INIT},
            resume=resume,
        )
    mon = monitor if monitor is not None else StepMonitor(
        threshold=4.0, warmup=3
    )

    points: list[Optional[DesignPoint]] = [None] * n_cand
    failures: list[dict] = []
    resumed = 0
    pending: list[int] = []
    for i, (cand, cfg, fp) in enumerate(zip(candidates, cfgs_all, fps)):
        rec = restored.get(fp)
        if rec is None:
            pending.append(i)
            continue
        resumed += 1
        if rec["kind"] == "point":
            points[i] = DesignPoint(
                index=i,
                cfg=cfg,
                encoder=cand.encoder,
                rand_index=float(rec["rand_index"]),
                synapses=int(rec["synapses"]),
                area_um2=float(rec["area_um2"]),
                leakage_uw=float(rec["leakage_uw"]),
                params={"w": np.asarray(rec["w"], np.float32)},
                lowering=rec.get("lowering", ""),
                buckets=int(rec.get("buckets", 1)),
                shards=int(rec.get("shards", 1)),
                fingerprint=fp,
                retries=int(rec.get("retries", 0)),
                plan=rec.get("plan"),
            )
        else:
            failures.append(
                {
                    "index": i,
                    "encoder": cand.encoder,
                    "stage": rec.get("stage", ""),
                    "error": rec.get("error", ""),
                    "lowerings": list(rec.get("lowerings", ())),
                    "retries": int(rec.get("retries", 0)),
                    "restored": True,
                }
            )

    t0 = time.perf_counter()
    obs.record("explore.prepare", t_prepare, t0)
    for encoder in dict.fromkeys(candidates[i].encoder for i in pending):
        idxs = [i for i in pending if candidates[i].encoder == encoder]
        cfgs = [cfgs_all[i] for i in idxs]
        with obs.span("explore.prepare"):
            w_init = [initial_weights(seed, i, cfgs_all[i]) for i in idxs]

        def on_bucket(local_idxs, results, idxs=idxs, encoder=encoder):
            recs = []
            for li, r in zip(local_idxs, results):
                gi = idxs[li]
                if isinstance(r, simulator.EvalFailure):
                    f = {
                        "index": gi,
                        "encoder": encoder,
                        "stage": r.stage,
                        "error": r.error,
                        "lowerings": list(r.lowerings),
                        "retries": r.retries,
                    }
                    failures.append({**f, "restored": False})
                    recs.append({"kind": "failure", "fp": fps[gi], **f})
                    continue
                syn = cfgs_all[gi].synapse_count
                w = r.params["w"].detach().cpu().numpy().astype(np.float32)
                p = DesignPoint(
                    index=gi,
                    cfg=cfgs_all[gi],
                    encoder=encoder,
                    rand_index=r.rand_index,
                    synapses=syn,
                    area_um2=float(forecaster.area_um2(syn)),
                    leakage_uw=float(forecaster.leakage_uw(syn)),
                    params={"w": w},
                    lowering=r.lowering,
                    buckets=r.buckets,
                    shards=r.shards,
                    fingerprint=fps[gi],
                    retries=r.retries,
                    plan=r.plan,
                )
                points[gi] = p
                recs.append(
                    {
                        "kind": "point",
                        "fp": fps[gi],
                        "index": gi,
                        "encoder": encoder,
                        "cand": dataclasses.asdict(candidates[gi]),
                        "rand_index": p.rand_index,
                        "synapses": p.synapses,
                        "area_um2": p.area_um2,
                        "leakage_uw": p.leakage_uw,
                        "lowering": p.lowering,
                        "buckets": p.buckets,
                        "shards": p.shards,
                        "retries": p.retries,
                        "plan": p.plan,
                        "w": w.tolist(),
                    }
                )
            if jr is not None:
                jr.append(recs)

        simulator.cluster_time_series_many(
            series, labels, cfgs, epochs=epochs, seed=seed, encoder=encoder,
            waste_cap=waste_cap, max_bucket=max_bucket, on_error=on_error,
            w_init=w_init, bucket_callback=on_bucket, monitor=mon,
            device=device,
        )
    t1 = time.perf_counter()
    seconds = t1 - t0

    done = [p for p in points if p is not None]
    encoders = list(dict.fromkeys(c.encoder for c in candidates))
    lowering_by_encoder = {
        e: ",".join(
            sorted({p.lowering for p in done if p.encoder == e and p.lowering})
        )
        for e in encoders
        if any(p.encoder == e for p in done)
    }
    buckets_by_encoder = {
        e: max(p.buckets for p in done if p.encoder == e)
        for e in encoders
        if any(p.encoder == e for p in done)
    }
    result = DSEResult(
        points=done,
        pareto=pareto_front(done),
        seconds=seconds,
        meta={
            "search": search,
            "candidates": len(done),
            "buckets": buckets_by_encoder,
            "shards": 1,
            "lowering": lowering_by_encoder,
            "epochs": epochs,
            "seed": seed,
            "on_error": on_error,
            "failures": failures,
            "quarantined": len(failures),
            "retries": (
                sum(p.retries for p in done)
                + sum(f["retries"] for f in failures)
            ),
            "fallbacks": sum(1 for p in done if p.retries > 0),
            "stalls": [dataclasses.asdict(ev) for ev in mon.events],
            "resumed": resumed,
            "journal": jr.path if jr is not None else None,
        },
    )
    obs.mark("explore.rank", t1)
    return result


def summarize(result: DSEResult) -> str:
    """Human-readable frontier table (the example prints this)."""
    meta = result.meta
    lines = [
        f"{len(result.points)} designs explored in {result.seconds:.2f}s "
        f"(buckets={meta['buckets']}, shards={meta['shards']}, "
        f"lowering={meta['lowering']})",
    ]
    if meta.get("quarantined"):
        by_stage: dict[str, int] = {}
        for f in meta["failures"]:
            by_stage[f["stage"]] = by_stage.get(f["stage"], 0) + 1
        lines.append(
            f"{meta['quarantined']} candidate(s) quarantined "
            f"({', '.join(f'{k}: {v}' for k, v in sorted(by_stage.items()))})"
            " — see meta['failures']"
        )
    if meta.get("resumed"):
        lines.append(f"{meta['resumed']} candidate(s) restored from journal")
    if meta.get("stalls"):
        lines.append(f"{len(meta['stalls'])} stalled bucket(s) flagged")
    lines.append("Pareto frontier (Rand index vs forecasted TNN area/leakage):")
    for p in result.pareto:
        lines.append(
            f"  enc={p.encoder:7s} q={p.cfg.q:3d} t_max={p.cfg.t_max:4d} "
            f"th={p.cfg.neuron.threshold:7.1f}  RI={p.rand_index:.3f}  "
            f"syn={p.synapses:6d}  area={p.area_um2:9.0f} um^2  "
            f"leak={p.leakage_uw:7.2f} uW"
        )
    return "\n".join(lines)
