"""Long-lived streaming clustering service over envelope-bucketed NSPUs.

The serving pipeline, stage by stage (each independently testable):

* **admission** — ``submit`` validates a request against its design's
  envelope *before any device work*: an unknown design, a series whose
  encoded width does not match its design, or non-finite samples raise a
  structured ``RequestRejected``.  Admission is also where overload
  control bites: a bounded pending queue (``max_pending``) sheds with
  ``reason='overloaded'`` and a retry-after hint, and a per-request
  deadline budget sheds with ``reason='deadline'`` when the predicted
  queue wait already exceeds it.
* **encode** — the series becomes a spike volley via the central encoder
  dispatch (``encoding.encode``), using the target design's gamma window,
  once, at admission, on the host.
* **bucket dispatch** — designs are packed into shared padding envelopes
  at construction (``backend.envelope_buckets``); a request rides the
  queue of its design's bucket and is batched with requests for *any*
  design in that bucket.
* **assign** — a full micro-batch (or a ``flush``-forced partial one,
  silent-padded to the batch size through
  ``fused_column.pad_stream_silent``) is copied to the device once and
  assigned by ONE ``fused_column.assign_padded`` call: on the card, one
  ``fire_block`` launch while the bucket's weights sit on the integer
  grid, else the float-weight fire in plain PyTorch.  A request whose
  deadline expired while queued is shed at dispatch (a structured
  ``ServeShed``), before its batch touches the device.
* **re-fit** — every ``refit_every`` served requests per bucket, the live
  weights take an online-STDP pass over the most recent
  ``refit_window`` volleys each design served
  (``fused_column.fit_scan_padded``: on the card ``fused_block``
  launches, in blocks of the ``v_blk`` of ``backend.execution_plan``).
  The candidate never overwrites the live block (the scan returns new
  weights) and commits only if it is finite and came within the watchdog
  budget; otherwise the attempt goes down ``backend.lowering_ladder``
  (one rung on the card: ``('cuda',)``) and, when every rung failed, the
  bucket enters **degraded mode**: serving continues from last-good
  weights while re-fit attempts back off exponentially
  (``backend.refit_backoff``).  Ragged buffers are silent-padded: for
  the positive thresholds the service enforces, a silent volley is an
  exact weight no-op, so the re-fit is bit-identical to an offline
  ``fit_scan_padded`` resume on the same volleys.
* **durability** — with ``durable_dir`` set, every committed re-fit is
  appended to a volley WAL and every ``snapshot_every`` re-fits the live
  weights snapshot atomically; ``ClusteringService.recover(dir)``
  replays WAL re-fits on top of the latest snapshot and restores weights
  bit-identical to the uninterrupted service (``serve.durability``).

Failures quarantine per request: if a batch raises, each live request
re-runs alone through the same entry point (assignment is per-volley
independent, so batch-mates' answers are bit-identical to the batched
run) and only the poisoned request surfaces a ``ServeFailure``.

The service is synchronous and single-threaded; "concurrent streams" are
interleaved logical streams multiplexed by the caller.  Stage timings
feed a ``distributed.straggler.StepMonitor`` (stages labelled
``'assign'`` / ``'refit'``) so stalls are observable through ``stats()``.

The port's counterpart of the JAX package's ``serve/service.py``, with
the same semantics stage by stage.  Where it differs:

* ``device`` (``__init__`` and ``recover``): the card unless asked
  otherwise (``backend.default_device``).  The durable spec does not
  record it, so a directory written on the card recovers on the CPU and
  the other way round.
* Initial weights drawn from the seed come from ``dse.initial_weights``
  (``column.init_params`` from a CPU ``torch.Generator`` seeded by
  (seed, design index)); they are NOT the JAX package's (parity runs
  pass ``weights=``).
* No ahead-of-time executables: the entry points are
  ``fused_column.assign_padded`` / ``fit_scan_padded``, looked up through
  the module at every call (the seam ``testing.faults`` patches).  The
  kernels build at their first launch, which ``warmup`` makes.
* Each bucket keeps its thresholds, ``t_max``es and live-neuron counts as
  host sequences, so no batch pays a device-to-host copy for them.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Mapping, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import backend as backend_lib
from repro_torch.core import encoding
from repro_torch.core.types import column_config_from_dict
from repro_torch.distributed.straggler import StepMonitor
from repro_torch.dse.explore import initial_weights
from repro_torch.kernels import fused_column
from repro_torch.serve import durability


class RequestRejected(Exception):
    """Structured admission failure — raised by ``submit`` before any
    device work happens.

    ``reason`` is machine-readable: ``'unknown-design'``, ``'shape'``,
    ``'envelope'`` (encoded width does not match the design),
    ``'non-finite'``, ``'overloaded'`` (bounded queue full),
    ``'deadline'`` (predicted wait exceeds the request's budget) or
    ``'draining'`` (the service is shutting down).  Load-shedding
    rejections carry ``retry_after_s``, a hint for when capacity should
    free up.
    """

    def __init__(self, reason: str, detail: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason
        self.detail = detail
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One served assignment: ``cluster`` is the earliest-firing neuron
    index of the target design, or its ``q`` when the volley was silent
    (unclustered)."""

    request_id: int
    design: str
    cluster: int
    latency_s: float


@dataclasses.dataclass(frozen=True)
class ServeFailure:
    """A quarantined request: the batch it rode failed, and so did its
    solo re-run.  Batch-mates are unaffected."""

    request_id: int
    design: str
    stage: str
    error: str


@dataclasses.dataclass(frozen=True)
class ServeShed:
    """A request shed at dispatch: admitted, but its deadline expired
    while it queued — no device work was spent on it."""

    request_id: int
    design: str
    reason: str
    waited_s: float


@dataclasses.dataclass(frozen=True)
class ServeStats:
    offered: int          # every submit() call, accepted or not
    submitted: int        # admitted into a queue
    served: int
    rejected: int         # admission rejections, total
    rejections: dict      # per-reason admission rejection counts
    shed: int             # admitted but deadline-expired at dispatch
    failed: int
    batches: int
    isolations: int
    refits: int           # committed online re-fits
    refit_failures: int   # re-fit windows where every ladder rung failed
    refit_stalls: int     # rung attempts discarded by the watchdog budget
    recoveries: int       # degraded buckets that re-fit successfully again
    degraded: int         # buckets currently serving from last-good weights
    stalls: int
    pending: int
    snapshots: int        # snapshots published this process
    wal_records: int      # WAL re-fits not yet covered by a snapshot
    replayed: int         # WAL re-fits replayed during recover()
    # per-bucket ExecutionPlan.meta() dicts — ({assign}, {fit|None}) per
    # bucket (the constants plan)
    plans: tuple = ()


class PendingRequest:
    """Handle returned by ``submit``; ``result()`` forces the request's
    bucket to flush if it is still queued."""

    def __init__(self, service: "ClusteringService", rid: int, design: str):
        self._service = service
        self.id = rid
        self.design = design
        self.outcome: Optional[
            Union[ServeResult, ServeFailure, ServeShed]
        ] = None

    @property
    def done(self) -> bool:
        return self.outcome is not None

    def result(self) -> Union[ServeResult, ServeFailure, ServeShed]:
        if self.outcome is None:
            self._service.flush(self.design)
        assert self.outcome is not None
        return self.outcome


class _Request:
    __slots__ = ("pending", "lane", "enc", "t_submit", "deadline")

    def __init__(self, pending, lane, enc, t_submit, deadline):
        self.pending = pending
        self.lane = lane
        self.enc = enc
        self.t_submit = t_submit
        self.deadline = deadline


class _Bucket:
    """One envelope bucket: live weights on the device + per-design host
    scalars + queue + degraded-mode state."""

    def __init__(self, index, envelope, names, cfgs, w0):
        self.index = index
        self.envelope = envelope  # (p_env, q_env, t_window)
        self.names = list(names)
        self.cfgs = list(cfgs)
        self.w = w0  # [Db, p_env, q_env] f32 tensor — replaced by re-fits
        # host sequences: the entry points read them as host floats
        self.thresholds = [float(c.neuron.threshold) for c in cfgs]
        self.t_maxes = [int(c.t_max) for c in cfgs]
        self.q_actives = [int(c.q) for c in cfgs]
        c0 = cfgs[0]
        self.fit_lowering = backend_lib.padded_lowering(c0.neuron.response, w0)
        self.asg_lowering = backend_lib.assign_lowering(c0.neuron.response, w0)
        self.queue: list[_Request] = []
        self.buffers: list[list[np.ndarray]] = [[] for _ in cfgs]
        # ExecutionPlans of the bucket's two shapes (filled in by the
        # service, which owns the batch / re-fit geometry); reporting only
        self.asg_plan = None
        self.fit_plan = None
        self.served_since_refit = 0
        # degraded-mode state: after every ladder rung fails a re-fit
        # window, the bucket keeps serving from the last-good weights and
        # sits out `cooldown` re-fit windows before retrying
        self.degraded = False
        self.failed_refits = 0
        self.cooldown = 0
        self.last_refit_errors: list[str] = []


class ClusteringService:
    """Streaming front-end over a fleet of NSPU column designs.

    Args:
      designs: ``{name: ColumnConfig}`` (or ``(name, cfg)`` pairs).  All
        designs must share the fused statics (response, ``w_max``, WTA k,
        STDP mus/mode) — the same constraint as the sweep front-end — and
        every threshold must be positive (the silent-volley no-op that
        partial batches and ragged re-fits rely on).
      encoder: ``'latency'`` or ``'onoff'`` (admission uses
        ``encoding.encoded_width`` to pin series length to design width).
      batch_size: requests per assignment micro-batch; a full queue
        auto-executes, ``flush`` silent-pads a partial one.
      refit_every: served requests per bucket between online re-fits
        (0 disables re-fitting).
      refit_window: volleys per design each re-fit trains on (the most
        recent served).
      refit_epochs: STDP epochs per re-fit.
      seed: seeds the initial weights of designs without ``weights``
        (``dse.initial_weights(seed, index, cfg)``); these are not the
        JAX package's seed-drawn weights.
      weights: optional ``{name: [p, q] array}`` initial weights (e.g.
        from an offline ``cluster_time_series`` fit).
      max_pending: bound on the total queued (unexecuted) requests across
        all buckets; beyond it ``submit`` sheds with
        ``RequestRejected(reason='overloaded')`` and a retry-after hint.
        ``None`` (default) leaves admission unbounded.
      default_deadline_s: deadline budget applied to every request that
        does not pass its own ``deadline_s``; a request whose predicted
        queue wait exceeds its budget is shed at admission
        (``reason='deadline'``), and one whose budget expires while
        queued is shed at dispatch (a ``ServeShed`` outcome) — either
        way, before any device work is spent on it.
      refit_budget_s: watchdog budget for one re-fit attempt, timed to
        the end of its device work; an attempt exceeding it is discarded
        as stalled (its result is thrown away) and the ladder moves on.
        ``None`` disables the budget.
      durable_dir: directory for crash durability (snapshots + re-fit
        WAL — see ``serve.durability``).  Must be fresh; resume an
        existing one with ``ClusteringService.recover(dir)``.
      snapshot_every: committed re-fits between snapshots (with
        ``durable_dir``); the WAL covers the gap.
      monitor: a ``StepMonitor`` for stage timings (one is created by
        default; stalls surface in ``stats()``).
      device: where the weights live and the kernels run; None means the
        card (raises without one).
    """

    def __init__(
        self,
        designs,
        *,
        encoder: str = "latency",
        batch_size: int = 16,
        refit_every: int = 64,
        refit_window: int = 32,
        refit_epochs: int = 1,
        seed: int = 0,
        weights: Optional[Mapping[str, np.ndarray]] = None,
        waste_cap: Optional[float] = None,
        max_bucket: Optional[int] = None,
        max_pending: Optional[int] = None,
        default_deadline_s: Optional[float] = None,
        refit_budget_s: Optional[float] = None,
        durable_dir: Optional[str] = None,
        snapshot_every: int = 4,
        monitor: Optional[StepMonitor] = None,
        device=None,
        _attach: bool = False,
    ):
        cfg_map = dict(designs)
        if not cfg_map:
            raise ValueError("service needs at least one design")
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if refit_window < 1:
            raise ValueError("refit_window must be >= 1")
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        if snapshot_every < 1:
            raise ValueError("snapshot_every must be >= 1")
        # unknown encoder raises here, at construction
        encoding.encoded_width(1, encoder)
        self.device = backend_lib.default_device(device)
        self.encoder = encoder
        self.batch_size = int(batch_size)
        self.refit_every = int(refit_every)
        self.refit_window = int(refit_window)
        self.refit_epochs = int(refit_epochs)
        self.max_pending = max_pending
        self.default_deadline_s = default_deadline_s
        self.refit_budget_s = refit_budget_s
        self.snapshot_every = int(snapshot_every)
        self._seed = int(seed)
        self._waste_cap = waste_cap
        self._max_bucket = max_bucket
        self.monitor = monitor if monitor is not None else StepMonitor(
            threshold=4.0, warmup=3
        )

        names = list(cfg_map)
        cfgs = [cfg_map[n] for n in names]
        c0 = cfgs[0]
        probe = torch.empty(0, device=self.device)
        for n, c in zip(names, cfgs):
            fused_column.check_fusable(
                c, backend_lib.padded_lowering(c.neuron.response, probe)
            )
            if c.neuron.threshold <= 0:
                raise ValueError(
                    f"design {n!r}: threshold must be > 0 — the service "
                    "pads partial batches and ragged re-fit windows with "
                    "silent volleys, which are weight no-ops only above "
                    "threshold 0"
                )
            same = (
                c.neuron.response == c0.neuron.response
                and c.neuron.w_max == c0.neuron.w_max
                and c.wta == c0.wta
                and c.stdp == c0.stdp
            )
            if not same:
                raise ValueError(
                    f"design {n!r}: all designs must share response/w_max/"
                    "WTA/STDP statics (one fused program per bucket)"
                )
        self._cfgs = cfg_map
        self._statics = dict(
            w_max=c0.neuron.w_max, wta_k=c0.wta.k,
            mu_capture=c0.stdp.mu_capture, mu_backoff=c0.stdp.mu_backoff,
            mu_search=c0.stdp.mu_search,
            stabilize=c0.stdp.stabilizer == "half",
            response=c0.neuron.response,
        )

        # ---- bucket construction: pack design shapes into envelopes and
        # assemble each bucket's live weight block on the host (the sweep
        # idiom), then move it to the device once
        shapes = [(c.p, c.q, c.t_max) for c in cfgs]
        buckets = backend_lib.envelope_buckets(shapes, waste_cap, max_bucket)
        self._buckets: list[_Bucket] = []
        self._route: dict[str, tuple[_Bucket, int]] = {}
        for bi, (env, members) in enumerate(buckets):
            p_env, q_env, _ = env
            w0 = np.zeros((len(members), p_env, q_env), np.float32)
            for lane, i in enumerate(members):
                c = cfgs[i]
                if weights is not None and names[i] in weights:
                    wi = np.asarray(weights[names[i]], np.float32)
                    if wi.shape != (c.p, c.q):
                        raise ValueError(
                            f"weights[{names[i]!r}]: expected shape "
                            f"{(c.p, c.q)}, got {wi.shape}"
                        )
                else:
                    wi = initial_weights(seed, i, c)
                w0[lane, : c.p, : c.q] = wi
            bucket = _Bucket(
                bi, env, [names[i] for i in members],
                [cfgs[i] for i in members],
                torch.from_numpy(w0).to(self.device),
            )
            bucket.asg_plan = backend_lib.execution_plan(
                "assign", bucket.asg_lowering, len(members), self.batch_size)
            if self.refit_every > 0:
                bucket.fit_plan = backend_lib.execution_plan(
                    "fit", bucket.fit_lowering, len(members), self.refit_window)
            self._buckets.append(bucket)
            for lane, i in enumerate(members):
                self._route[names[i]] = (bucket, lane)

        self._next_id = 0
        self._offered = 0
        self._submitted = 0
        self._served = 0
        self._rejected = 0
        self._rejections: dict[str, int] = {}
        self._shed = 0
        self._failed = 0
        self._batches = 0
        self._isolations = 0
        self._refits = 0
        self._refit_failures = 0
        self._refit_stalls = 0
        self._recoveries = 0
        self._snapshots = 0
        self._replayed = 0
        self._refit_seq = 0
        self._batch_ewma: Optional[float] = None
        self._draining = False

        # ---- durability: fresh directories get meta + WAL header + a
        # seq-0 snapshot of the initial weights; recover() attaches to an
        # existing directory, restores the latest snapshot and replays
        # the WAL tail (bit-identical — weights only ever mutate at
        # committed re-fits, and each WAL record is one committed
        # re-fit's exact input window)
        self._store: Optional[durability.DurableStore] = None
        if durable_dir is not None:
            spec = self._replay_spec()
            fingerprint = durability.service_fingerprint(spec)
            store = durability.DurableStore(durable_dir)
            if _attach:
                step, records = store.attach(fingerprint)
                blocks, _ = store.ckpt.restore(
                    [b.w for b in self._buckets], step=step,
                    device=self.device,
                )
                for b, wb in zip(self._buckets, blocks):
                    self._commit_weights(b, wb)
                self._store = store
                self._refit_seq = step
                for rec in records:
                    self._replay(rec)
            else:
                store.create(
                    {
                        "version": durability.DURABLE_VERSION,
                        "fingerprint": fingerprint,
                        "spec": spec,
                        "serving": {
                            "batch_size": self.batch_size,
                            "refit_every": self.refit_every,
                            "snapshot_every": self.snapshot_every,
                            "max_pending": self.max_pending,
                            "default_deadline_s": self.default_deadline_s,
                            "refit_budget_s": self.refit_budget_s,
                        },
                    },
                    [b.w for b in self._buckets],
                )
                self._store = store

    # -------------------------------------------------------- durability
    def _replay_spec(self) -> dict:
        """The replay-relevant service identity: everything that pins
        bucket structure, init weights and re-fit semantics — NOT the
        serving knobs (batch size, deadlines, device...), which a
        recovered service may legitimately change."""
        return {
            "names": list(self._cfgs),
            "cfgs": [dataclasses.asdict(c) for c in self._cfgs.values()],
            "encoder": self.encoder,
            "seed": self._seed,
            "refit_window": self.refit_window,
            "refit_epochs": self.refit_epochs,
            "waste_cap": self._waste_cap,
            "max_bucket": self._max_bucket,
            "statics": dict(self._statics),
        }

    @classmethod
    def recover(cls, durable_dir: str, *, monitor: Optional[StepMonitor] =
                None, device=None, **overrides) -> "ClusteringService":
        """Rebuild a service from its durable directory: reconstruct the
        fleet from ``meta.json``, restore the latest published snapshot
        onto ``device`` (None: the card), and replay the WAL's committed
        re-fits on top — weights come back **bit-identical** to the
        uninterrupted service at its last committed re-fit (a kill loses
        at most the re-fit in flight, and the served-but-unrefit volley
        buffers).

        Serving knobs (``batch_size``, ``max_pending``, deadlines, ...)
        default to the values recorded at creation; pass ``overrides`` to
        change them.  Call ``warmup()`` on the recovered service before
        taking traffic, as usual.
        """
        meta = durability.DurableStore(durable_dir).load_meta()
        if meta.get("version") != durability.DURABLE_VERSION:
            raise ValueError(
                f"{durable_dir}: durable format version "
                f"{meta.get('version')} != {durability.DURABLE_VERSION}"
            )
        spec = meta["spec"]
        designs = {
            n: column_config_from_dict(d)
            for n, d in zip(spec["names"], spec["cfgs"])
        }
        kwargs = dict(meta.get("serving", {}))
        kwargs.update(
            encoder=spec["encoder"], seed=spec["seed"],
            refit_window=spec["refit_window"],
            refit_epochs=spec["refit_epochs"],
            waste_cap=spec["waste_cap"], max_bucket=spec["max_bucket"],
        )
        kwargs.update(overrides)
        return cls(
            designs, monitor=monitor, durable_dir=durable_dir, device=device,
            _attach=True, **kwargs,
        )

    def _replay(self, rec: dict) -> None:
        """Apply one WAL re-fit record — same ladder, same commit path as
        the live re-fit, no budget (a recovering process builds its
        kernels here) and no re-logging."""
        bucket = self._buckets[rec["bucket"]]
        xs = np.asarray(rec["xs"], np.int32)
        w_new, _low, errors = self._attempt_window(
            bucket, xs, ladder=backend_lib.lowering_ladder(
                bucket.fit_lowering
            ),
            label="replay", enforce_budget=False,
        )
        if w_new is None:
            # the record committed in a prior life; failing here means the
            # environment changed — keep serving from the snapshot weights
            warnings.warn(
                f"WAL replay: re-fit seq {rec['seq']} failed every rung "
                f"({errors}); continuing from pre-record weights"
            )
            self._refit_failures += 1
        else:
            self._commit_weights(bucket, w_new)
        self._refit_seq = int(rec["seq"])
        self._replayed += 1

    def _snapshot(self) -> None:
        if self._store is None:
            return
        self._store.snapshot(
            self._refit_seq, [b.w for b in self._buckets]
        )
        self._snapshots += 1

    def drain(self) -> ServeStats:
        """Graceful shutdown: stop admission (``submit`` now sheds with
        ``reason='draining'``), serve every queued request, and publish a
        final snapshot so recovery replays nothing.  Idempotent; the
        SIGTERM path of ``launch/serve_tnn.py`` calls this."""
        self._draining = True
        self.flush()
        self._snapshot()
        return self.stats()

    @property
    def draining(self) -> bool:
        return self._draining

    # ------------------------------------------------------------- intro
    def designs(self) -> tuple[str, ...]:
        return tuple(self._cfgs)

    def buckets(self) -> list[dict]:
        """Bucket-dispatch summary: one dict per envelope."""
        return [
            {
                "envelope": b.envelope,
                "designs": tuple(b.names),
                "batch_shape": (self.batch_size, len(b.names), b.envelope[0]),
                "refit_shape": (
                    self.refit_window, len(b.names), b.envelope[0]
                ),
                "degraded": b.degraded,
                "cooldown": b.cooldown,
                "assign_plan": b.asg_plan.meta() if b.asg_plan else None,
                "fit_plan": b.fit_plan.meta() if b.fit_plan else None,
            }
            for b in self._buckets
        ]

    def weights(self, design: str) -> np.ndarray:
        """Host copy of a design's live weights, cropped to its (p, q)."""
        bucket, lane = self._route[design]
        c = self._cfgs[design]
        return bucket.w[lane, : c.p, : c.q].cpu().clone().numpy()

    def stats(self) -> ServeStats:
        return ServeStats(
            offered=self._offered,
            submitted=self._submitted,
            served=self._served,
            rejected=self._rejected,
            rejections=dict(self._rejections),
            shed=self._shed,
            failed=self._failed,
            batches=self._batches,
            isolations=self._isolations,
            refits=self._refits,
            refit_failures=self._refit_failures,
            refit_stalls=self._refit_stalls,
            recoveries=self._recoveries,
            degraded=sum(1 for b in self._buckets if b.degraded),
            stalls=len(self.monitor.events),
            pending=sum(len(b.queue) for b in self._buckets),
            snapshots=self._snapshots,
            wal_records=self._store.pending if self._store else 0,
            replayed=self._replayed,
            plans=tuple(
                (
                    b.asg_plan.meta() if b.asg_plan else None,
                    b.fit_plan.meta() if b.fit_plan else None,
                )
                for b in self._buckets
            ),
        )

    # ------------------------------------------------------------ warmup
    def warmup(self) -> dict:
        """Run every bucket's serving path once before traffic, so the
        kernels it launches are built (they build at their first launch)
        and no build happens while serving.

        Per bucket: one all-silent batch and one all-silent re-fit run
        end-to-end through the real serving path — silent volleys assign
        to "unclustered" (discarded) and are exact weight no-ops, so
        warmup changes no answers and no weights.
        """
        t0 = time.perf_counter()
        for b in self._buckets:
            self._assign(b, self._silent_batch(b))
            if self.refit_every > 0:
                self._refit(b, warm=True)  # silent window: exact no-op
        return {
            "buckets": len(self._buckets),
            "seconds": time.perf_counter() - t0,
        }

    # --------------------------------------------------------- admission
    def _reject(self, reason: str, detail: str,
                retry_after_s: Optional[float] = None) -> None:
        self._rejected += 1
        self._rejections[reason] = self._rejections.get(reason, 0) + 1
        raise RequestRejected(reason, detail, retry_after_s)

    def _batch_seconds(self) -> float:
        """Recent EWMA of one batched assignment's wall time (0.0 until
        the first post-warmup batch lands)."""
        return self._batch_ewma if self._batch_ewma is not None else 0.0

    def _wait_estimate_s(self, bucket: _Bucket) -> float:
        """Predicted queue wait for a request admitted to ``bucket`` now:
        batches ahead of it (its own included) times the recent batch
        time."""
        batches_ahead = len(bucket.queue) // self.batch_size + 1
        return batches_ahead * self._batch_seconds()

    def submit(self, series, design: str,
               deadline_s: Optional[float] = None) -> PendingRequest:
        """Admit one series for ``design``; raises ``RequestRejected`` on
        admission failure (including load shedding), returns a
        ``PendingRequest`` otherwise.  A full bucket queue executes
        immediately (the returned handle is then already ``done``).

        ``deadline_s`` is this request's latency budget (defaults to the
        service-wide ``default_deadline_s``): the request is shed at
        admission if the predicted queue wait already exceeds it, and at
        dispatch if it expired while queued.
        """
        self._offered += 1
        with obs.span("serve.admit") as sp:
            bucket, pending, t_submit = self._admit(series, design, deadline_s)
            if obs.ON:
                sp.end(t_submit, (pending.id,))
        if len(bucket.queue) >= self.batch_size:
            self._execute(bucket)
        return pending

    def _admit(self, series, design: str, deadline_s: Optional[float]
               ) -> tuple[_Bucket, PendingRequest, float]:
        """Validate, estimate the wait against the deadline, encode and
        enqueue one request; returns its bucket, its handle and the
        reading it was enqueued at."""
        if self._draining:
            self._reject(
                "draining", "service is draining; no new work accepted"
            )
        if self.max_pending is not None:
            pending = sum(len(b.queue) for b in self._buckets)
            if pending >= self.max_pending:
                self._reject(
                    "overloaded",
                    f"{pending} pending requests >= max_pending="
                    f"{self.max_pending}",
                    retry_after_s=(
                        pending / self.batch_size
                    ) * self._batch_seconds(),
                )
        route = self._route.get(design)
        if route is None:
            self._reject(
                "unknown-design",
                f"{design!r} not served (have {sorted(self._route)})",
            )
        bucket, lane = route
        cfg = self._cfgs[design]
        x = np.asarray(series, np.float64)
        if x.ndim != 1:
            self._reject(
                "shape", f"expected one series [L], got shape {x.shape}"
            )
        width = encoding.encoded_width(x.shape[0], self.encoder)
        if width != cfg.p:
            self._reject(
                "envelope",
                f"series of length {x.shape[0]} encodes to width {width}, "
                f"which no bucket accepts (design {design!r} "
                f"envelope takes width {cfg.p})",
            )
        if not np.isfinite(x).all():
            self._reject(
                "non-finite", f"series for {design!r} has non-finite samples"
            )
        deadline = (
            deadline_s if deadline_s is not None else self.default_deadline_s
        )
        if deadline is not None:
            est = self._wait_estimate_s(bucket)
            if est > deadline:
                self._reject(
                    "deadline",
                    f"predicted wait {est:.4f}s exceeds deadline budget "
                    f"{deadline:.4f}s",
                    retry_after_s=est,
                )
        # encoded in float32 on the host, as the simulator encodes
        t = obs.now()
        enc = encoding.encode(
            torch.as_tensor(x, dtype=torch.float32), cfg.t_max, self.encoder
        ).numpy()
        obs.mark("serve.encode", t)
        pending = PendingRequest(self, self._next_id, design)
        self._next_id += 1
        self._submitted += 1
        t_submit = time.perf_counter()
        bucket.queue.append(_Request(pending, lane, enc, t_submit, deadline))
        return bucket, pending, t_submit

    def flush(self, design: Optional[str] = None) -> None:
        """Execute partial batches now (all buckets, or ``design``'s)."""
        buckets = (
            self._buckets if design is None else [self._route[design][0]]
        )
        with obs.span("serve.flush"):
            for b in buckets:
                while b.queue:
                    self._execute(b)

    # --------------------------------------------------------- execution
    def _silent_batch(self, bucket: _Bucket) -> np.ndarray:
        p_env, _, t_window = bucket.envelope
        return np.full(
            (self.batch_size, len(bucket.names), p_env), t_window, np.int32
        )

    def _batch_xs(self, bucket: _Bucket, reqs: list[_Request]) -> np.ndarray:
        """Assemble [B, Db, p_env] on the host: each request's volley in
        its design's lane, every other lane silent, partial batches padded
        to the batch size through the ragged-batch seam."""
        p_env, _, t_window = bucket.envelope
        xs = np.full(
            (len(reqs), len(bucket.names), p_env), t_window, np.int32
        )
        for n, r in enumerate(reqs):
            xs[n, r.lane, : r.enc.shape[0]] = r.enc
        return fused_column.pad_stream_silent(
            torch.from_numpy(xs), self.batch_size, t_window
        ).numpy()

    def _assign(self, bucket: _Bucket, xs_np: np.ndarray) -> np.ndarray:
        """Ids [Db, B] of one host batch: one copy to the device, one
        ``assign_padded`` call, one copy of the ids back."""
        t = obs.now()
        ids = fused_column.assign_padded(
            bucket.w, torch.from_numpy(xs_np).to(self.device),
            bucket.thresholds, bucket.t_maxes, bucket.q_actives,
            t_window=bucket.envelope[2], response=self._statics["response"],
            lowering=bucket.asg_lowering, w_max=self._statics["w_max"],
        )
        t = obs.mark("serve.fire", t)
        obs.count("serve.lanes_fired", xs_np.shape[0] * xs_np.shape[1])
        ids = ids.cpu().numpy()
        obs.mark("serve.d2h", t)
        return ids

    def _shed_expired(self, reqs: list[_Request]) -> list[_Request]:
        """Drop deadline-expired requests from a popped batch BEFORE any
        device work — their budget is already blown, serving them would
        only delay the live ones."""
        now = time.perf_counter()
        live = []
        for r in reqs:
            waited = now - r.t_submit
            if r.deadline is not None and waited > r.deadline:
                self._shed += 1
                obs.request(r.pending.id, r.t_submit, now, now, "shed")
                r.pending.outcome = ServeShed(
                    r.pending.id, r.pending.design, "deadline", waited
                )
            else:
                live.append(r)
        return live

    def _trace_served(self, reqs: list[_Request], t_dispatched: float,
                      t_done: float) -> None:
        """The tracer's records and counters of one fire's live requests
        (call only with tracing on)."""
        obs.count("serve.batch_live", len(reqs))
        obs.count("serve.batch_slots", self.batch_size)
        for r in reqs:
            obs.request(r.pending.id, r.t_submit, t_dispatched, t_done,
                        "served")

    def _execute(self, bucket: _Bucket) -> None:
        reqs = bucket.queue[: self.batch_size]
        del bucket.queue[: self.batch_size]
        if not reqs:
            return
        reqs = self._shed_expired(reqs)
        if not reqs:
            return
        # one clock reading a boundary: the span, the monitor, the batch
        # EWMA and the requests' latencies share t0 and done
        t0 = time.perf_counter()
        attrs = (
            (bucket.index, len(reqs), tuple(r.pending.id for r in reqs))
            if obs.ON else ()
        )
        with obs.span("serve.batch", attrs, t0=t0):
            try:
                with obs.span("serve.assemble"):
                    xs = self._batch_xs(bucket, reqs)
                ids = self._assign(bucket, xs)
            except Exception:  # noqa: BLE001 - quarantined below
                ids = None
            done = time.perf_counter()
            self.monitor.observe_next(done - t0, "assign")
            if ids is not None:
                self._batch_ewma = (
                    done - t0 if self._batch_ewma is None
                    else 0.8 * self._batch_ewma + 0.2 * (done - t0)
                )
                self._batches += 1
                with obs.span("serve.complete", t0=done):
                    for n, r in enumerate(reqs):
                        self._complete(
                            bucket, r,
                            ServeResult(
                                r.pending.id, r.pending.design,
                                int(ids[r.lane, n]), done - r.t_submit,
                            ),
                        )
                    if obs.ON:
                        self._trace_served(reqs, t0, done)
        if ids is None:
            self._isolate(bucket, reqs)
            return
        self._maybe_refit(bucket)

    def _isolate(self, bucket: _Bucket, reqs: list[_Request]) -> None:
        """Quarantine: re-run each request of a failed batch alone through
        the SAME entry point (one live row, rest silent) — assignment is
        per-volley independent, so survivors' answers are bit-identical
        to the batched run; only the poisoned request fails."""
        self._isolations += 1
        with obs.span("serve.isolate", (bucket.index, len(reqs))
                      if obs.ON else ()):
            for r in reqs:
                t0 = time.perf_counter()
                try:
                    ids = self._assign(bucket, self._batch_xs(bucket, [r]))
                except Exception as e:
                    done = time.perf_counter()
                    self.monitor.observe_next(done - t0, "assign")
                    self._failed += 1
                    r.pending.outcome = ServeFailure(
                        r.pending.id, r.pending.design, "assign", repr(e)
                    )
                    obs.request(r.pending.id, r.t_submit, t0, done, "failed")
                    continue
                done = time.perf_counter()
                self.monitor.observe_next(done - t0, "assign")
                self._batches += 1
                self._complete(
                    bucket, r,
                    ServeResult(
                        r.pending.id, r.pending.design,
                        int(ids[r.lane, 0]), done - r.t_submit,
                    ),
                )
                if obs.ON:
                    self._trace_served([r], t0, done)
        self._maybe_refit(bucket)

    def _complete(
        self, bucket: _Bucket, r: _Request, result: ServeResult
    ) -> None:
        r.pending.outcome = result
        self._served += 1
        bucket.served_since_refit += 1
        if self.refit_every > 0:
            buf = bucket.buffers[r.lane]
            buf.append(r.enc)
            if len(buf) > self.refit_window:
                del buf[: len(buf) - self.refit_window]

    # ------------------------------------------------------------ re-fit
    def _refit_xs(self, bucket: _Bucket) -> np.ndarray:
        """[R, Db, p_env] re-fit window: each design's buffered volleys in
        arrival order, ragged tails silent (exact no-ops above threshold
        0, so training on the padded window == training on the buffered
        volleys alone)."""
        p_env, _, t_window = bucket.envelope
        xs = np.full(
            (self.refit_window, len(bucket.names), p_env), t_window, np.int32
        )
        for lane, buf in enumerate(bucket.buffers):
            for k, enc in enumerate(buf):
                xs[k, lane, : enc.shape[0]] = enc
        return xs

    def _fit_window(self, bucket: _Bucket, xs_np: np.ndarray,
                    lowering: str) -> torch.Tensor:
        """One fused online-STDP pass over a host window, from the live
        block (``fit_scan_padded`` returns new weights and leaves its
        input as it is, so a failed or discarded attempt never touches
        the last-good weights).  Ends with a device synchronisation, so
        the watchdog times the re-fit and not its launch."""
        plan = backend_lib.execution_plan(
            "fit", lowering, len(bucket.names), xs_np.shape[0])
        w_new = fused_column.fit_scan_padded(
            bucket.w, torch.from_numpy(xs_np).to(self.device),
            bucket.thresholds, bucket.t_maxes, bucket.q_actives,
            t_window=bucket.envelope[2],
            epochs=self.refit_epochs, lowering=lowering, v_blk=plan.v_blk,
            **self._statics,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return w_new

    def _attempt_window(self, bucket: _Bucket, xs_np: np.ndarray, *,
                        ladder, label: str = "refit",
                        enforce_budget: bool = True):
        """Try one re-fit window down ``ladder``; a rung fails on raise,
        non-finite weights, or (with the watchdog budget enforced) a wall
        time over ``refit_budget_s``.  Returns ``(w_new, lowering,
        errors)`` — ``w_new`` is ``None`` when every rung failed."""
        errors: list[str] = []
        for low in ladder:
            t0 = time.perf_counter()
            try:
                w_new = self._fit_window(bucket, xs_np, low)
            except Exception as e:
                t1 = time.perf_counter()
                self.monitor.observe_next(t1 - t0, label)
                obs.record("serve.refit_fit", t0, t1)
                errors.append(f"{low}: {e!r}")
                continue
            t1 = time.perf_counter()
            dt = t1 - t0
            self.monitor.observe_next(dt, label)
            obs.record("serve.refit_fit", t0, t1)
            if (
                enforce_budget
                and self.refit_budget_s is not None
                and dt > self.refit_budget_s
            ):
                self._refit_stalls += 1
                errors.append(
                    f"{low}: stalled ({dt:.3f}s > refit_budget_s="
                    f"{self.refit_budget_s:.3f}s) — result discarded"
                )
                continue
            with obs.span("serve.refit_check"):
                finite = bool(torch.isfinite(w_new).all())
            if not finite:
                errors.append(f"{low}: non-finite weights (poisoned re-fit)")
                continue
            return w_new, low, errors
        return None, None, errors

    def _commit_weights(self, bucket: _Bucket, w_new) -> None:
        bucket.w = torch.as_tensor(
            w_new, dtype=torch.float32, device=self.device
        ).contiguous()
        # the kernel fires the integer grid: it serves the bucket only
        # while every lane's weights sit on it (re-checked on each commit)
        bucket.asg_lowering = backend_lib.assign_lowering(
            self._statics["response"], bucket.w
        )

    def _refit(self, bucket: _Bucket, warm: bool = False) -> None:
        with obs.span("serve.refit", (bucket.index,) if obs.ON else ()):
            self._refit_bucket(bucket, warm)

    def _refit_bucket(self, bucket: _Bucket, warm: bool) -> None:
        t = obs.now()
        xs = self._refit_xs(bucket)
        obs.mark("serve.refit_window", t)
        if warm:
            # warmup's all-silent window: single rung, no budget (the
            # kernel may still be building), no WAL, no counters
            w_new, _, _ = self._attempt_window(
                bucket, xs, ladder=(bucket.fit_lowering,),
                enforce_budget=False,
            )
            if w_new is not None:
                t = obs.now()
                self._commit_weights(bucket, w_new)
                obs.mark("serve.commit", t)
        else:
            w_new, _low, errors = self._attempt_window(
                bucket, xs,
                ladder=backend_lib.lowering_ladder(bucket.fit_lowering),
            )
            if w_new is None:
                # degraded mode: keep serving from last-good weights;
                # retry after an exponentially growing number of windows
                self._refit_failures += 1
                bucket.failed_refits += 1
                bucket.cooldown = backend_lib.refit_backoff(
                    bucket.failed_refits
                )
                bucket.degraded = True
                bucket.last_refit_errors = errors
            else:
                t = obs.now()
                self._commit_weights(bucket, w_new)
                self._refits += 1
                self._refit_seq += 1
                if bucket.degraded:
                    bucket.degraded = False
                    bucket.failed_refits = 0
                    bucket.cooldown = 0
                    bucket.last_refit_errors = []
                    self._recoveries += 1
                if self._store is not None:
                    self._store.log_refit(
                        self._refit_seq, bucket.index, self.refit_epochs,
                        _low, xs,
                    )
                    if self._refit_seq % self.snapshot_every == 0:
                        self._snapshot()
                obs.mark("serve.commit", t)
        for buf in bucket.buffers:
            buf.clear()
        bucket.served_since_refit = 0

    def _maybe_refit(self, bucket: _Bucket) -> None:
        if (
            self.refit_every <= 0
            or bucket.served_since_refit < self.refit_every
            or not any(bucket.buffers)
        ):
            return
        if bucket.cooldown > 0:
            # degraded backoff: sit this window out (buffers keep rolling,
            # capped at refit_window) and wait a full window before the
            # next decision
            bucket.cooldown -= 1
            bucket.served_since_refit = 0
            return
        self._refit(bucket)
