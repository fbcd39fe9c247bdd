"""TNNGen functional simulator front end (paper §II-A).

Ties encoding + column/network inference + online STDP + clustering
metrics into the "rapid application exploration" loop the paper
describes.  The ``mode`` knob selects a backend from the registry
(``repro_torch.core.backend``):

  'auto'   — hybrid: event-driven closed form where exact (RNL/SNL),
             cycle-accurate loop where required (LIF); training routes to
             the fused column step whenever the config fits its contract.
  'event'  — force the closed form.
  'cycle'  — force the cycle-accurate loop.
  'pallas' — force the fused kernel path: the CUDA kernels on the card,
             their plain PyTorch versions on the CPU.

Three clustering front ends share the loop, each on the card unless the
caller passes ``device='cpu'``:

* ``cluster_time_series`` — one column design, one stream.
* ``cluster_time_series_many`` — a design sweep: designs pack into shared
  (p, q, t_max) padding envelopes (``backend.envelope_buckets``); each
  bucket trains as one padded scan whose per-design threshold, window,
  live-neuron count and mus are runtime operands (the volley-block kernel
  on the card), and assigns in one batched pass.
* ``cluster_time_series_network`` — a multi-layer ``NetworkConfig``,
  trained greedily layer by layer (``network.fit_greedy``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.clustering.metrics import rand_index as rand_index_fn
from repro_torch.core import backend as backend_lib
from repro_torch.core import column as column_lib
from repro_torch.core import encoding
from repro_torch.core.types import ColumnConfig, NetworkConfig, TIME_DTYPE
from repro_torch.kernels import fused_column


@dataclasses.dataclass
class ClusteringResult:
    assignments: np.ndarray  # [N] cluster ids (q == unclustered)
    rand_index: float
    # {'w': [p, q] tensor} for a column (a sweep member cropped to its
    # true size); {'layers': [{'w': [columns, p, q]}, ...]} for a network
    params: dict
    train_seconds: float
    mode: str
    # lowering the fused training path ran on: 'cuda' or 'reference' (or
    # 'cycle' for a sweep member that degraded to the solver), '' when
    # training resolved to the event/cycle solvers, comma-joined when a
    # network's fused layers mixed lowerings
    lowering: str = ""
    # sweep metadata: envelope buckets of the sweep, and cards this
    # design's bucket split its design axis across (1: one card)
    buckets: int = 1
    shards: int = 1
    # on_error='isolate' sweeps: ladder rungs that failed before the one
    # recorded in ``lowering`` ran (0: the first choice ran)
    retries: int = 0
    # ExecutionPlan.meta() of the fused fit; None on solver paths
    plan: Optional[dict] = None


@dataclasses.dataclass
class EvalFailure:
    """A quarantined design evaluation of an ``on_error='isolate'`` sweep.

    Attributes:
      index: the design's position in the sweep's input order.
      stage: 'fit' (every ladder rung raised), 'weights' (non-finite
        weights after training) or 'silent' (no output spike on any
        volley, so the Rand index is undefined).
      error: the last exception's repr, or the guard's diagnostic.
      lowerings: the ladder rungs attempted, in order.
      retries: failed attempts before giving up (== len(lowerings) for
        'fit'; for a post-check failure the rung that ran is last).
    """

    index: int
    stage: str
    error: str
    lowerings: tuple = ()
    retries: int = 0

    @property
    def rand_index(self) -> float:
        """NaN: a quarantined design carries no quality information."""
        return float("nan")


SweepOutcome = Union[ClusteringResult, EvalFailure]


def suggest_threshold(cfg: ColumnConfig) -> float:
    """Default firing threshold: a quarter of the expected saturated
    potential p * w_max / 2 of uniform weights, which keeps spike times
    mid-window."""
    return max(1.0, 0.25 * cfg.p * cfg.neuron.w_max / 2.0)


def _encode_width(
    x: torch.Tensor, t_max: int, width: int, encoder: str
) -> torch.Tensor:
    volleys = encoding.encode(x, t_max, encoder)
    if volleys.shape[-1] != width:
        raise ValueError(
            f"encoded width {volleys.shape[-1]} != design input width {width}"
        )
    return volleys


def _encode(x: torch.Tensor, cfg: ColumnConfig, encoder: str) -> torch.Tensor:
    return _encode_width(x, cfg.t_max, cfg.p, encoder)


def _series(series, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(series), dtype=torch.float32).to(device)


def cluster_time_series(
    series: np.ndarray,
    labels: Optional[np.ndarray],
    cfg: ColumnConfig,
    epochs: int = 8,
    mode: str = "auto",
    seed: int = 0,
    encoder: str = "latency",
    device=None,
    params: Optional[dict] = None,
) -> ClusteringResult:
    """End-to-end: encode -> online STDP -> assign clusters -> rand index.

    Args:
      series: [N, L] real-valued series (L == cfg.p for 'latency', 2L ==
        cfg.p for 'onoff'); encoded in float32, as the JAX package does.
      labels: [N] integer class labels, or None (rand_index = nan).
      cfg: column config (p x q).
      epochs: STDP passes over the data.
      mode: simulation backend, resolved by ``backend.resolve``.
      seed: seeds the one ``torch.Generator`` (weight init, plus the draws
        of stochastic/random configs).  Its weights are not JAX's.
      device: where to run; None means the card (raises without one).
      params: initial weights {'w': [p, q]} (e.g. from
        ``column.params_from_jax``) instead of drawing them.

    ``train_seconds`` covers training and assignment, ended by the copy
    of the assignments to the host.
    """
    with obs.span("single.column"):
        return _cluster_time_series(
            series, labels, cfg, epochs, mode, seed, encoder, device, params
        )


def _cluster_time_series(
    series, labels, cfg, epochs, mode, seed, encoder, device, params
) -> ClusteringResult:
    device = backend_lib.default_device(device)
    t = obs.now()
    volleys = _encode(_series(series, device), cfg, encoder)
    t = obs.mark("single.encode", t)
    generator = torch.Generator().manual_seed(seed)
    if params is None:
        params = column_lib.init_params(cfg, generator, device)
    else:
        params = column_lib.init_params(cfg, device=device, w=params["w"])

    t0 = time.perf_counter()
    obs.record("single.init", t, t0)
    params = column_lib.fit(
        params, volleys, cfg, epochs=epochs, mode=mode, generator=generator
    )
    t = obs.mark("single.fit", t0)
    assignments = (
        column_lib.cluster_assignments(params, volleys, cfg, mode).cpu().numpy()
    )
    t1 = time.perf_counter()
    train_seconds = t1 - t0
    obs.record("single.assign", t, t1)

    ri = float("nan")
    if labels is not None:
        ri = float(rand_index_fn(np.asarray(labels), assignments))
    resolved = backend_lib.resolve(mode, cfg, training=True)
    lowering = (
        backend_lib.padded_lowering(cfg.neuron.response, volleys)
        if resolved == "pallas"
        else ""
    )
    obs.mark("single.score", t1)
    return ClusteringResult(assignments, ri, params, train_seconds, mode, lowering)


def assign_time_series(
    series: np.ndarray,
    cfg: ColumnConfig,
    params: dict,
    encoder: str = "latency",
    device=None,
) -> np.ndarray:
    """Cluster ids from frozen trained weights, with no training pass.

    Encodes one series [L] (returns a scalar id) or a batch [N, L]
    (returns [N] ids) and fires it against ``params['w']``.  Configs
    inside the fused fire contract go through ``fused_column.assign_padded``
    (on the card one launch of the integer-grid fire kernel when the
    weights sit on the grid, else of the float-weight one, for RNL); the
    rest (LIF) through ``column.cluster_assignments``.
    Ids: the earliest-firing neuron, ``cfg.q`` for a silent volley.
    """
    device = backend_lib.default_device(device)
    x = _series(series, device)
    single = x.dim() == 1
    if single:
        x = x[None]
    volleys = _encode(x, cfg, encoder)
    w = torch.as_tensor(params["w"], dtype=torch.float32).to(device)
    try:
        fused_column.check_fusable(cfg, "reference")
    except ValueError:
        ids = column_lib.cluster_assignments({"w": w}, volleys, cfg, "auto")
    else:
        ids = fused_column.assign_padded(
            w[None], volleys[:, None, :], [cfg.neuron.threshold],
            [cfg.t_max], [cfg.q], t_window=cfg.t_max,
            response=cfg.neuron.response,
            lowering=backend_lib.assign_lowering(cfg.neuron.response, w),
            w_max=cfg.neuron.w_max,
        )[0]
    ids = ids.cpu().numpy()
    return ids[0] if single else ids


# --------------------------------------------------- batched design sweep
def _sweep_bucket(
    cfgs: Sequence[ColumnConfig],
    idxs: Sequence[int],
    envelope: tuple[int, int, int],
    enc: Sequence[torch.Tensor],
    w_init: Sequence[np.ndarray],
    epochs: int,
    lowering: str,
) -> tuple[np.ndarray, list[torch.Tensor], int, dict]:
    """Train and assign one envelope bucket of a design sweep.

    Pads the members into the bucket's (p_env, q_env, t_window) envelope
    (pad synapses silent at t_window, pad neurons past each q_active),
    trains them as one padded scan (``fused_column.fit_scan_padded``, in
    blocks of the plan's ``v_blk``) and assigns every volley in one
    batched pass (``fused_column.assign_padded``).

    Returns (assignments [Db, N], cropped per-design weights, shard
    count, plan metadata).
    """
    c0 = cfgs[idxs[0]]
    p_env, q_env, t_window = envelope
    db = len(idxs)
    dev = enc[idxs[0]].device
    n = enc[idxs[0]].shape[0]

    t = obs.now()
    encb = torch.stack([enc[i] for i in idxs], dim=1)  # [N, Db, p]
    xs = torch.full((n, db, p_env), t_window, dtype=TIME_DTYPE, device=dev)
    xs[:, :, : encb.shape[-1]] = encb
    w0 = np.zeros((db, p_env, q_env), np.float32)
    for j, i in enumerate(idxs):
        w0[j, : cfgs[i].p, : cfgs[i].q] = w_init[i]
    w0 = torch.from_numpy(w0).to(dev)
    thresholds = [cfgs[i].neuron.threshold for i in idxs]
    t_maxes = [cfgs[i].t_max for i in idxs]
    q_actives = [cfgs[i].q for i in idxs]
    t = obs.mark("sweep.pad", t)

    plan = backend_lib.execution_plan("fit", lowering, db, n)
    t = obs.mark("sweep.plan", t)
    w = fused_column.fit_scan_padded(
        w0, xs, thresholds, t_maxes, q_actives,
        t_window=t_window, w_max=c0.neuron.w_max, wta_k=c0.wta.k,
        mu_capture=c0.stdp.mu_capture, mu_backoff=c0.stdp.mu_backoff,
        mu_search=c0.stdp.mu_search,
        stabilize=c0.stdp.stabilizer == "half",
        response=c0.neuron.response, epochs=epochs, lowering=lowering,
        v_blk=plan.v_blk,
    )
    t = obs.mark("sweep.fit", t)
    # the grid kernel fires the integer grid, so it runs only when the
    # trained weights sit on it; float weights take the reference lowering
    # (the float-weight kernel on the card)
    asg = fused_column.assign_padded(
        w, xs, thresholds, t_maxes, q_actives, t_window=t_window,
        response=c0.neuron.response,
        lowering=backend_lib.assign_lowering(c0.neuron.response, w),
        w_max=c0.neuron.w_max,
    ).cpu().numpy()
    obs.mark("sweep.assign", t)
    w_out = [w[j, : cfgs[i].p, : cfgs[i].q] for j, i in enumerate(idxs)]
    return asg, w_out, plan.shards, plan.meta()


def _eval_design_solver(
    cfg: ColumnConfig, volleys: torch.Tensor, w0: np.ndarray, epochs: int
) -> tuple[np.ndarray, torch.Tensor]:
    """The 'cycle' rung: one design on the cycle-accurate solver.  Only
    reached where ``backend.cycle_exact`` holds, i.e. where it gives the
    fused path's result bit for bit."""
    params = column_lib.init_params(cfg, device=volleys.device, w=w0)
    params = column_lib.fit(params, volleys, cfg, epochs=epochs, mode="cycle")
    asg = column_lib.cluster_assignments(params, volleys, cfg, "cycle")
    return asg.cpu().numpy(), params["w"]


def _design_guard(
    cfg: ColumnConfig, asg_i: np.ndarray, w_i: torch.Tensor
) -> Optional[tuple[str, str]]:
    """Post-training checks of one design of a guarded sweep: (stage,
    diagnostic) for non-finite weights or a fully silent design, None for
    a healthy one."""
    w_np = w_i.detach().cpu().numpy()
    if not np.all(np.isfinite(w_np)):
        return (
            "weights",
            f"non-finite weights after training "
            f"(nan={int(np.isnan(w_np).sum())}, "
            f"inf={int(np.isinf(w_np).sum())})",
        )
    if np.all(np.asarray(asg_i) == cfg.q):
        return (
            "silent",
            "silent design: no output spikes on any volley, "
            "Rand index undefined",
        )
    return None


def _eval_bucket_guarded(
    cfgs: Sequence[ColumnConfig],
    idxs: Sequence[int],
    envelope: tuple[int, int, int],
    enc: Sequence[torch.Tensor],
    w_init: Sequence[np.ndarray],
    epochs: int,
    lowering: str,
) -> list:
    """Fault-isolated evaluation of one envelope bucket.

    Runs the whole bucket on its lowering first; if that fails, each
    member runs alone in its own envelope down ``backend.lowering_ladder``
    (on the card that is 'cuda' alone: a kernel failure is never retried
    as plain PyTorch; on the CPU the 'cycle' solver follows 'reference'
    where ``backend.cycle_exact`` proves it exact), so one bad design is
    quarantined alone.  Every attempt is recorded.

    Returns one outcome per member: ``('ok', asg, w, shards, lowering_ran,
    retries, plan_meta)`` or an ``EvalFailure``.
    """
    attempts: list[tuple[str, str]] = []
    try:
        asg_b, w_b, shards, plan_meta = _sweep_bucket(
            cfgs, idxs, envelope, enc, w_init, epochs, lowering
        )
        return [
            ("ok", asg_b[j], w_b[j], shards, lowering, 0, plan_meta)
            for j in range(len(idxs))
        ]
    except Exception as e:  # noqa: BLE001 — the guard is the feature
        attempts.append((lowering, repr(e)))
    out = []
    for i in idxs:
        c = cfgs[i]
        d_attempts = list(attempts)
        done = None
        solo_ladder = backend_lib.lowering_ladder(
            lowering, cycle_exact=backend_lib.cycle_exact(c, w_init[i]),
        )[: backend_lib.MAX_EVAL_RETRIES]
        for low in solo_ladder:
            try:
                if low == "cycle":
                    asg_i, w_i = _eval_design_solver(
                        c, enc[i], w_init[i], epochs
                    )
                    plan_i = None
                else:
                    asg_1, w_1, _, plan_i = _sweep_bucket(
                        cfgs, [i], (c.p, c.q, c.t_max), enc, w_init,
                        epochs, low,
                    )
                    asg_i, w_i = asg_1[0], w_1[0]
                done = ("ok", asg_i, w_i, 1, low, len(d_attempts), plan_i)
                break
            except Exception as e:  # noqa: BLE001
                d_attempts.append((low, repr(e)))
        if done is None:
            out.append(EvalFailure(
                index=i, stage="fit", error=d_attempts[-1][1],
                lowerings=tuple(l for l, _ in d_attempts),
                retries=len(d_attempts),
            ))
        else:
            out.append(done)
    return out


def cluster_time_series_many(
    series: np.ndarray,
    labels: Optional[np.ndarray],
    cfgs: Sequence[ColumnConfig],
    epochs: int = 8,
    seed: int = 0,
    encoder: str = "latency",
    waste_cap: Optional[float] = None,
    max_bucket: Optional[int] = None,
    on_error: str = "raise",
    w_init: Optional[Sequence[np.ndarray]] = None,
    bucket_callback: Optional[Callable] = None,
    monitor=None,
    device=None,
) -> list[SweepOutcome]:
    """Sweep several column designs over one stream, envelope-bucketed.

    Designs pack into shared (p, q, t_max) padding envelopes
    (``backend.envelope_buckets`` under ``waste_cap`` and ``max_bucket``);
    each bucket trains as one padded scan on the fused path (the
    volley-block kernel on the card, its plain version on the CPU) and
    assigns in one batched pass.  Bucketing never changes a result
    (``waste_cap=float('inf')`` puts every design in one envelope and
    gives the same answers).

    Every design must fit the fused contract and share response, w_max,
    STDP and WTA configs; q, t_max and threshold vary freely, and p is
    the encoded width.  ``seed`` draws the designs' initial weights from
    one ``torch.Generator`` in input order, unless ``w_init`` gives one
    [p, q] array per design.  An empty stream raises; ``epochs=0``
    assigns from the initial weights.

    ``on_error='raise'`` (default) propagates any failure and never
    changes lowering.  ``'isolate'`` turns per-design failures into
    ``EvalFailure`` records: a failing bucket re-runs design by design
    down ``backend.lowering_ladder`` (recorded in ``lowering``/
    ``retries``; on the card the ladder is 'cuda' alone, so a kernel that
    fails to build or launch quarantines its designs and never runs as
    plain PyTorch), and designs with non-finite weights or no output
    spike are quarantined.
    ``bucket_callback(idxs, outcomes)`` runs after each bucket;
    ``monitor`` is any object with ``start()``/``stop()``, called around
    each bucket.  ``train_seconds`` on every result is the whole sweep's
    wall time.
    """
    with obs.span("sweep.run"):
        return _cluster_time_series_many(
            series, labels, cfgs, epochs, seed, encoder, waste_cap,
            max_bucket, on_error, w_init, bucket_callback, monitor, device,
        )


def _cluster_time_series_many(
    series, labels, cfgs, epochs, seed, encoder, waste_cap, max_bucket,
    on_error, w_init, bucket_callback, monitor, device,
) -> list[SweepOutcome]:
    if on_error not in ("raise", "isolate"):
        raise ValueError(
            f"unknown on_error: {on_error!r} ('raise' | 'isolate')"
        )
    if not cfgs:
        return []
    device = backend_lib.default_device(device)
    t = obs.now()
    x = _series(series, device)
    obs.mark("sweep.encode", t)
    c0 = cfgs[0]
    lowering = backend_lib.padded_lowering(c0.neuron.response, x)
    for c in cfgs:
        fused_column.check_fusable(c, lowering)
        same = (
            c.neuron.response == c0.neuron.response
            and c.neuron.w_max == c0.neuron.w_max
            and c.stdp == c0.stdp
            and c.wta == c0.wta
        )
        if not same:
            raise ValueError(
                "cluster_time_series_many needs designs sharing response, "
                "w_max, STDP and WTA configs"
            )
    if x.shape[0] == 0:
        raise ValueError(
            "cluster_time_series_many needs a non-empty stream (got N=0 "
            "series)"
        )
    d = len(cfgs)
    t = obs.now()
    enc = [_encode(x, c, encoder) for c in cfgs]  # D x [N, p]
    t = obs.mark("sweep.encode", t)
    if w_init is None:
        generator = torch.Generator().manual_seed(seed)
        w_init = [
            column_lib.init_params(c, generator, "cpu")["w"].numpy()
            for c in cfgs
        ]
    else:
        if len(w_init) != d:
            raise ValueError(
                f"w_init must provide one array per config "
                f"({len(w_init)} != {d})"
            )
        w_init = [np.asarray(w, np.float32) for w in w_init]
        for w, c in zip(w_init, cfgs):
            if w.shape != (c.p, c.q):
                raise ValueError(
                    f"w_init shape {w.shape} != design shape {(c.p, c.q)}"
                )
    t = obs.mark("sweep.init", t)

    buckets = backend_lib.envelope_buckets(
        [(c.p, c.q, c.t_max) for c in cfgs],
        waste_cap=waste_cap, max_bucket=max_bucket,
    )
    out: list[Optional[SweepOutcome]] = [None] * d
    t0 = time.perf_counter()
    obs.record("sweep.buckets", t, t0)
    for bi, (envelope, idxs) in enumerate(buckets):
        with obs.span("sweep.bucket",
                      (bi, len(idxs), envelope) if obs.ON else ()):
            if obs.ON:
                p_env, q_env, t_window = envelope
                obs.count("sweep.volume_live", sum(
                    cfgs[i].p * cfgs[i].q * cfgs[i].t_max for i in idxs))
                obs.count("sweep.volume_padded",
                          len(idxs) * p_env * q_env * t_window)
            _sweep_one(cfgs, labels, idxs, envelope, enc, w_init, epochs,
                       lowering, on_error, len(buckets), out, monitor,
                       bucket_callback)
    train_seconds = time.perf_counter() - t0
    for r in out:
        if isinstance(r, ClusteringResult):
            r.train_seconds = train_seconds
    return out


def _sweep_one(cfgs, labels, idxs, envelope, enc, w_init, epochs, lowering,
               on_error, n_buckets, out, monitor, bucket_callback) -> None:
    """One bucket of a sweep: train and assign it, score its designs into
    ``out``, then hand them to ``bucket_callback``."""
    if monitor is not None:
        monitor.start()
    if on_error == "isolate":
        evals = _eval_bucket_guarded(
            cfgs, idxs, envelope, enc, w_init, epochs, lowering
        )
    else:
        asg_b, w_b, shards, plan_meta = _sweep_bucket(
            cfgs, idxs, envelope, enc, w_init, epochs, lowering
        )
        evals = [
            ("ok", asg_b[j], w_b[j], shards, lowering, 0, plan_meta)
            for j in range(len(idxs))
        ]
    bucket_out: list[SweepOutcome] = []
    with obs.span("sweep.score"):
        for i, ev in zip(idxs, evals):
            if not isinstance(ev, EvalFailure):
                _, asg_i, w_i, shards_i, low_i, retries_i, plan_i = ev
                bad = (
                    _design_guard(cfgs[i], asg_i, w_i)
                    if on_error == "isolate" else None
                )
                if bad is not None:
                    ev = EvalFailure(
                        index=i, stage=bad[0], error=bad[1],
                        lowerings=(low_i,), retries=retries_i,
                    )
                else:
                    ri = float("nan")
                    if labels is not None:
                        ri = float(rand_index_fn(np.asarray(labels), asg_i))
                    ev = ClusteringResult(
                        np.asarray(asg_i), ri, {"w": w_i}, 0.0, "pallas",
                        low_i, buckets=n_buckets, shards=shards_i,
                        retries=retries_i, plan=plan_i,
                    )
            out[i] = ev
            bucket_out.append(ev)
    if monitor is not None:
        monitor.stop()
    if bucket_callback is not None:
        with obs.span("sweep.callback"):
            bucket_callback(list(idxs), bucket_out)


# --------------------------------------------------- multi-layer networks
def cluster_time_series_network(
    series: np.ndarray,
    labels: Optional[np.ndarray],
    cfg: NetworkConfig,
    epochs: int = 8,
    mode: str = "auto",
    seed: int = 0,
    encoder: str = "latency",
    device=None,
    params: Optional[list] = None,
) -> ClusteringResult:
    """End-to-end clustering with a multi-layer TNN design.

    The loop of ``cluster_time_series`` with a ``NetworkConfig``: layer
    l's post-WTA volleys feed layer l+1, layers train greedily
    (``network.fit_greedy``, ``mode`` resolved per layer; fused layers
    train through ``fused_column.fit_scan_padded``), and the cluster id is the
    winner index in the last layer's concatenated output (out_width for
    a silent volley).  ``params`` ([{'w': [columns, p, q]}, ...], e.g.
    from ``network.params_from_jax``) replaces the seeded initial
    weights.  ``lowering`` joins the lowerings of the fused layers.
    """
    from repro_torch.core import network as network_lib

    device = backend_lib.default_device(device)
    volleys = _encode_width(
        _series(series, device), cfg.layers[0].column.t_max,
        network_lib.in_width(cfg), encoder,
    )
    generator = torch.Generator().manual_seed(seed)
    params = network_lib.init_params(
        cfg, volleys.shape[-1], generator, device, params=params
    )

    t0 = time.perf_counter()
    layer_plans: list = []
    params = network_lib.fit_greedy(
        params, volleys, cfg, epochs=epochs, mode=mode, generator=generator,
        plan_sink=layer_plans,
    )
    assignments = (
        network_lib.cluster_assignments(params, volleys, cfg, mode)
        .cpu().numpy()
    )
    train_seconds = time.perf_counter() - t0

    ri = float("nan")
    if labels is not None:
        ri = float(rand_index_fn(np.asarray(labels), assignments))
    lows = {
        backend_lib.padded_lowering(layer.column.neuron.response, volleys)
        for layer in cfg.layers
        if backend_lib.resolve(mode, layer.column, training=True) == "pallas"
    }
    return ClusteringResult(
        assignments, ri, {"layers": params}, train_seconds, mode,
        ",".join(sorted(lows)),
        plan={"layers": layer_plans} if layer_plans else None,
    )
