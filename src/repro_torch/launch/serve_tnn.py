"""TNN serving launcher: a live ClusteringService under synthetic streams.

    python -m repro_torch.launch.serve_tnn --smoke
    python -m repro_torch.launch.serve_tnn --streams 64 --requests 8
    python -m repro_torch.launch.serve_tnn --durable-dir svc   # crash-safe
    python -m repro_torch.launch.serve_tnn --smoke --device cpu

Stands up the streaming NSPU clustering service (``repro_torch.serve``)
over a small fleet of heterogeneous column designs, warms every envelope
bucket's serving path, then multiplexes ``--streams`` synthetic time-series streams
round-robin through admission -> encode -> bucket-dispatch -> assign ->
online re-fit, and prints sustained requests/sec, latency percentiles and
the service stats.

SIGTERM triggers a graceful drain: admission stops, every in-flight
request is served, and (with ``--durable-dir``) a final snapshot is
published before exit — zero dropped requests, exit 0.  ``--smoke``
shrinks everything for CI and raises SIGTERM on itself mid-run so the
drain path is exercised on every CI pass.  A ``--durable-dir`` that
already holds a durable service is resumed via
``ClusteringService.recover`` (weights restored bit-identical from
snapshot + WAL).

The port's counterpart of the JAX package's ``launch/serve_tnn.py``: the
same flags and ``[serve_tnn]`` lines, plus ``--device`` (the card unless
asked otherwise; without a card it raises and never carries on on the
CPU).
"""
import argparse
import os
import signal
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny geometry + few requests + self-SIGTERM (CI)")
    ap.add_argument("--designs", type=int, default=4)
    ap.add_argument("--streams", type=int, default=64,
                    help="concurrent synthetic streams (round-robin)")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per stream")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--refit-every", type=int, default=64)
    ap.add_argument("--length", type=int, default=24,
                    help="series length (= synapses under latency coding)")
    ap.add_argument("--t-max", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    ap.add_argument("--durable-dir", default=None,
                    help="snapshot+WAL directory; an existing durable "
                         "service there is resumed, a fresh directory is "
                         "initialized")
    args = ap.parse_args(argv)
    if args.smoke:
        args.designs = min(args.designs, 2)
        args.streams = min(args.streams, 8)
        args.requests = min(args.requests, 4)
        args.batch = min(args.batch, 4)
        args.refit_every = min(args.refit_every, 8)
        args.length = min(args.length, 12)
        args.t_max = min(args.t_max, 16)

    import numpy as np

    from repro_torch.core import simulator
    from repro_torch.core.types import ColumnConfig
    from repro_torch.serve import ClusteringService, RequestRejected, durability

    # heterogeneous q/t_max so several designs share one stream length but
    # (beyond the tightened waste cap below) split into more than one
    # envelope bucket at the default geometry
    cfgs = {}
    for i in range(args.designs):
        c = ColumnConfig(
            p=args.length, q=3 + 2 * (i % 2),
            t_max=args.t_max * (1 + (i // 2) % 2),
        )
        cfgs[f"nspu{i}"] = c.with_threshold(simulator.suggest_threshold(c))

    resumed = bool(
        args.durable_dir
        and os.path.exists(os.path.join(args.durable_dir,
                                        durability.META_FILE))
    )
    if resumed:
        service = ClusteringService.recover(
            args.durable_dir, batch_size=args.batch,
            refit_every=args.refit_every, device=args.device,
        )
        print(f"[serve_tnn] resumed durable service from "
              f"{args.durable_dir} (replayed "
              f"{service.stats().replayed} WAL re-fit(s))")
    else:
        service = ClusteringService(
            cfgs, batch_size=args.batch, refit_every=args.refit_every,
            refit_window=max(args.batch, args.refit_every), seed=args.seed,
            waste_cap=2.0, durable_dir=args.durable_dir, device=args.device,
        )
    warm = service.warmup()
    print(f"[serve_tnn] {len(service.designs())} designs in "
          f"{warm['buckets']} bucket(s) on {service.device}, warmup "
          f"{warm['seconds']*1e3:.0f} ms")
    for b in service.buckets():
        print(f"[serve_tnn]   envelope {b['envelope']} <- {b['designs']}")

    # graceful shutdown: SIGTERM stops admission and drains in-flight work
    term_requested = []
    prev_handler = signal.signal(
        signal.SIGTERM, lambda *_: term_requested.append(True)
    )

    names = list(service.designs())
    streams = [
        np.random.default_rng(args.seed + s) for s in range(args.streams)
    ]
    handles = []
    drained = False
    t0 = time.perf_counter()
    try:
        for r in range(args.requests):
            if term_requested:
                break
            for s, rng in enumerate(streams):
                if term_requested:
                    break
                design = names[s % len(names)]
                series = rng.normal(size=args.length)
                try:
                    handles.append(service.submit(series, design))
                except RequestRejected as e:  # not expected on this stream
                    print(f"[serve_tnn] rejected: {e}")
                if (args.smoke and r == args.requests // 2
                        and s == args.streams // 2):
                    # exercise the drain path on every CI pass: ask
                    # ourselves to shut down mid-round, with requests
                    # still queued behind a partial batch
                    print("[serve_tnn] smoke: raising SIGTERM on self")
                    signal.raise_signal(signal.SIGTERM)
        if term_requested:
            in_flight = sum(1 for h in handles if not h.done)
            print(f"[serve_tnn] SIGTERM: draining "
                  f"({in_flight} request(s) in flight)")
            service.drain()
            drained = True
        else:
            service.flush()
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
    elapsed = time.perf_counter() - t0

    lat = sorted(
        h.result().latency_s for h in handles if h.result() is not None
    )
    stats = service.stats()
    n = len(lat)
    rps = n / max(elapsed, 1e-9)
    p50 = lat[n // 2] * 1e3 if n else float("nan")
    p99 = lat[min(n - 1, int(n * 0.99))] * 1e3 if n else float("nan")
    print(f"[serve_tnn] {n} requests over {args.streams} streams in "
          f"{elapsed*1e3:.0f} ms -> {rps:.0f} req/s "
          f"(p50 {p50:.2f} ms, p99 {p99:.2f} ms)")
    print(f"[serve_tnn] stats: {stats}")

    dropped = sum(1 for h in handles if not h.done)
    if drained:
        if dropped or stats.failed or stats.pending:
            print(f"[serve_tnn] FAILED: drain dropped {dropped} request(s)")
            return 1
        print(f"[serve_tnn] drained cleanly: {len(handles)} admitted, "
              "0 dropped")
        return 0
    if stats.served != len(handles) or stats.failed or stats.pending:
        print("[serve_tnn] FAILED: not every request served")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
