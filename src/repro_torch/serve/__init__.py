"""Streaming NSPU clustering service of the port.

``ClusteringService`` holds a set of trained (or training) TNN column
designs behind an admission -> encode -> bucket-dispatch -> assign ->
re-fit pipeline: designs pack into shared padding envelopes
(``backend.envelope_buckets``), incoming series are latency-encoded on the
host and micro-batched by envelope into ONE batched assignment per batch
(``fused_column.assign_padded``: the ``fire_block`` kernel on the card
while the weights sit on the integer grid), and the live weights keep
learning via periodic online STDP re-fits that resume the fused scan from
the served stream (``fused_column.fit_scan_padded``: ``fused_block`` on
the card).  With a ``durable_dir`` the service is also crash-safe:
live-weight snapshots plus a re-fit volley WAL (``serve.durability``) let
``ClusteringService.recover(dir)`` restore weights bit-identical to the
uninterrupted service.  Admission is overload-safe — bounded queues and
per-request deadline budgets shed structured ``RequestRejected`` /
``ServeShed`` before any device work — and failed re-fits degrade to
serving from last-good weights instead of taking the service down.
"""
from repro_torch.serve import durability
from repro_torch.serve.service import (
    ClusteringService,
    PendingRequest,
    RequestRejected,
    ServeFailure,
    ServeResult,
    ServeShed,
    ServeStats,
)

__all__ = [
    "ClusteringService",
    "PendingRequest",
    "RequestRejected",
    "ServeFailure",
    "ServeResult",
    "ServeShed",
    "ServeStats",
    "durability",
]
