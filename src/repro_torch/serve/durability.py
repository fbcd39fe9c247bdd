"""Durable serving state: live-weight snapshots + a re-fit volley WAL.

Layout under one durable directory:

    <dir>/meta.json        service identity + serving knobs (atomic publish)
    <dir>/snapshots/       ``distributed.checkpoint.Checkpointer`` steps:
                           one step per re-fit sequence number, step 0 is
                           the initial weights, pruned to the newest two
    <dir>/wal.jsonl        append-only re-fit log SINCE the last snapshot

Durability contract (the serving analogue of the DSE journal's
kill-and-resume story):

* Live weights mutate ONLY at a successful online re-fit, so the full
  weight history is (snapshot at seq k) + (the exact re-fit windows for
  seqs k+1..n).  The WAL records each committed re-fit's input window —
  appended *after* the in-memory commit, fsync'd per append — and the
  fused scan is deterministic, so replaying the WAL on top of the
  snapshot restores weights **bit-identical** to the uninterrupted
  service.  A kill at any instant loses at most the re-fit in flight.
* Snapshots publish via the ``Checkpointer`` write-then-rename protocol
  (a preempted snapshot is never visible); the WAL is truncated only
  after its covering snapshot has published, so every committed re-fit
  is always reachable from (some published snapshot) + (the WAL tail).
* The WAL reader tolerates a torn trailing line (the un-fsync'd tail of
  a crash) by skipping it — exactly the journal's defensive-read rule.
* ``meta.json`` carries a fingerprint over the replay-relevant service
  spec (configs, encoder, seed, re-fit geometry); recovery refuses a
  directory whose fingerprint does not match the reconstructed service,
  rather than silently replaying volleys into a different fleet.

The port's copy of the JAX package's ``serve/durability.py``, numpy and
JSON only, on the port's ``Checkpointer``; the on-disk layout is the
same.  Weight blocks may be tensors on any device: the checkpointer
copies them to the host when the snapshot is taken.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from repro_torch.distributed.checkpoint import Checkpointer

DURABLE_VERSION = 1
META_FILE = "meta.json"
WAL_FILE = "wal.jsonl"
SNAPSHOT_DIR = "snapshots"
SNAPSHOTS_KEPT = 2


def service_fingerprint(spec: dict) -> str:
    """Deterministic identity of the replay-relevant service spec (the
    serving counterpart of ``dse.candidate_fingerprint``)."""
    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _atomic_write(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class VolleyWAL:
    """Append-only re-fit log with fsync'd appends and a torn-tail
    tolerant reader.

    Unlike the DSE journal (atomic full-rewrite per append, right for a
    few hundred records), the WAL is a true O(1) append per re-fit —
    the durable prefix is whatever has been fsync'd, and ``load`` skips
    any torn tail.  ``truncate_through`` (called under a fresh covering
    snapshot) rewrites atomically, journal-style.
    """

    def __init__(self, path: str):
        self.path = str(path)

    def create(self, fingerprint: str) -> None:
        header = {
            "kind": "meta", "version": DURABLE_VERSION,
            "fingerprint": fingerprint,
        }
        _atomic_write(self.path, json.dumps(header) + "\n")

    def load(self) -> list:
        """All intact records (header included); torn lines skipped."""
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn tail of a kill mid-append
        return out

    def validate(self, fingerprint: str) -> list:
        """Header-checked ``load``: refuses a WAL written by a service
        with a different replay spec; returns the refit records."""
        records = self.load()
        if not records or records[0].get("kind") != "meta":
            raise ValueError(f"{self.path}: missing WAL header")
        head = records[0]
        if head.get("version") != DURABLE_VERSION:
            raise ValueError(
                f"{self.path}: WAL version {head.get('version')} != "
                f"{DURABLE_VERSION}"
            )
        if head.get("fingerprint") != fingerprint:
            raise ValueError(
                f"{self.path}: WAL fingerprint {head.get('fingerprint')} "
                f"does not match this service ({fingerprint}) — refusing "
                "to replay volleys into a different fleet"
            )
        return [r for r in records[1:] if r.get("kind") == "refit"]

    def append(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def truncate_through(self, seq: int, fingerprint: str) -> None:
        """Atomically drop records with ``seq`` <= the covering snapshot's
        (they are now redundant); keep any newer tail."""
        keep = [
            r for r in self.load()
            if r.get("kind") == "refit" and r.get("seq", 0) > seq
        ]
        header = {
            "kind": "meta", "version": DURABLE_VERSION,
            "fingerprint": fingerprint,
        }
        lines = [json.dumps(header)] + [json.dumps(r) for r in keep]
        _atomic_write(self.path, "\n".join(lines) + "\n")


class DurableStore:
    """One durable directory: meta + snapshots + WAL, with the
    snapshot/WAL interplay (publish-then-truncate, prune) in one place."""

    def __init__(self, root: str):
        self.root = os.path.abspath(str(root))
        os.makedirs(self.root, exist_ok=True)
        self.ckpt = Checkpointer(os.path.join(self.root, SNAPSHOT_DIR))
        self.wal = VolleyWAL(os.path.join(self.root, WAL_FILE))
        self.fingerprint = ""
        self.pending = 0  # WAL refit records not yet covered by a snapshot

    @property
    def meta_path(self) -> str:
        return os.path.join(self.root, META_FILE)

    def exists(self) -> bool:
        return os.path.exists(self.meta_path)

    def load_meta(self) -> dict:
        if not self.exists():
            raise FileNotFoundError(
                f"{self.root}: no durable service here (missing {META_FILE})"
            )
        with open(self.meta_path) as f:
            return json.load(f)

    def create(self, meta: dict, blocks: list) -> None:
        """Initialize a fresh durable directory: meta, WAL header, and a
        blocking snapshot of the initial weights at seq 0 — recovery
        never re-derives init weights, it always restores a snapshot."""
        if self.exists():
            raise ValueError(
                f"{self.root} already holds a durable service — use "
                "ClusteringService.recover(dir) to resume it, or point "
                "durable_dir at a fresh directory"
            )
        self.fingerprint = meta["fingerprint"]
        _atomic_write(self.meta_path, json.dumps(meta, indent=2) + "\n")
        self.wal.create(self.fingerprint)
        self.ckpt.save(0, list(blocks), blocking=True)

    def attach(self, fingerprint: str) -> tuple:
        """Open an existing durable directory for recovery: validate the
        fingerprint, find the newest published snapshot, and return
        ``(snapshot_seq, records_to_replay)`` (WAL records newer than the
        snapshot, in sequence order)."""
        meta = self.load_meta()
        if meta.get("fingerprint") != fingerprint:
            raise ValueError(
                f"{self.meta_path}: fingerprint {meta.get('fingerprint')} "
                f"does not match the reconstructed service ({fingerprint})"
            )
        self.fingerprint = fingerprint
        step = self.ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"{self.root}: no published snapshot to recover from"
            )
        records = [
            r for r in self.wal.validate(fingerprint)
            if r.get("seq", 0) > step
        ]
        records.sort(key=lambda r: r["seq"])
        self.pending = len(records)
        return step, records

    def log_refit(
        self, seq: int, bucket: int, epochs: int, lowering: str,
        xs: np.ndarray,
    ) -> None:
        self.wal.append({
            "kind": "refit", "seq": int(seq), "bucket": int(bucket),
            "epochs": int(epochs), "lowering": lowering,
            "xs": np.asarray(xs).tolist(),
        })
        self.pending += 1

    def snapshot(self, seq: int, blocks: list) -> None:
        """Publish a snapshot at ``seq`` then truncate the WAL through it
        — strictly in that order, so every committed re-fit stays
        reachable at every instant — and prune old snapshots."""
        self.ckpt.save(int(seq), list(blocks), blocking=True)
        self.wal.truncate_through(int(seq), self.fingerprint)
        self.ckpt.prune(keep=SNAPSHOTS_KEPT)
        self.pending = 0
