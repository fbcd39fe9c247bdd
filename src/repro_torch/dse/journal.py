"""Durable journal for design-space exploration runs.

Long exploration runs (hundreds of candidate evaluations, minutes to
hours — the cluster-scale sweeps the ROADMAP targets) need the same
durability story the training stack has: a killed process must lose at
most the work in flight, never the completed evaluations.  This module
provides it for ``dse.explore``:

* Every completed evaluation — scored *or* quarantined — is one JSON
  record keyed by a **deterministic candidate fingerprint**
  (``candidate_fingerprint``: config + encoder + seed + epochs), so a
  record is valid exactly as long as re-evaluating the candidate would
  reproduce it.
* The journal is an **append-only JSONL file published atomically**: each
  append rewrites the full record list to ``<path>.tmp``, fsyncs, and
  ``os.replace``s it into place — the write-then-rename protocol of the
  JAX package's ``distributed/checkpoint.py``.  A SIGKILL mid-write can never corrupt
  the journal or be mistaken for a complete one; readers always see the
  last published state.  (DSE journals are small — hundreds of records of
  a few KB — so the rewrite stays cheap; appends happen once per
  completed *bucket*, which is also the resume granularity.)
* ``explore(journal=..., resume=True)`` skips every journaled candidate
  and re-evaluates only the rest; because init weights are keyed per
  candidate (not per sweep position), the resumed frontier is
  bit-identical to an uninterrupted run.

The port's counterpart of the JAX package's ``dse/journal.py``: the same
record format and the same ``candidate_fingerprint``.  Equal fingerprints
do not mean equal initial weights across the two packages (each draws
them from its own generator), so ``dse.explore`` puts the name of its
initializer into the run header, and ``begin`` refuses a journal whose
header differs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional, Sequence

from repro_torch.core.types import ColumnConfig

JOURNAL_VERSION = 1


def candidate_fingerprint(
    cfg: ColumnConfig, encoder: str, seed: int, epochs: int
) -> str:
    """Deterministic identity of one candidate evaluation.

    Hashes the full column config (every nested dataclass field), the
    encoder, and the run's seed and epoch count — everything the
    evaluation's result is a function of.  Equal fingerprints mean
    re-running the evaluation would reproduce the journaled result
    bit-for-bit; any config/seed/epochs change misses the journal and
    re-evaluates.  Stable across processes and hosts (canonical JSON +
    SHA-256, no Python hash randomization).
    """
    spec = {
        "cfg": dataclasses.asdict(cfg),
        "encoder": str(encoder),
        "seed": int(seed),
        "epochs": int(epochs),
    }
    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


class Journal:
    """Append-only JSONL evaluation journal with atomic publishes.

    Record kinds (one JSON object per line):

    * ``{"kind": "meta", "version", "seed", "epochs", "search", "init"}``
      — the run header, written by ``begin`` and validated on resume.
    * ``{"kind": "point", "fp", "index", "encoder", "cand", "rand_index",
      "synapses", "area_um2", "leakage_uw", "lowering", "buckets",
      "shards", "retries", "w"}`` — one scored design; ``w`` is the
      trained weight matrix (float32 values round-trip JSON exactly, so
      restored ``DesignPoint.params`` are bit-identical).
    * ``{"kind": "failure", "fp", "index", "encoder", "stage", "error",
      "lowerings", "retries"}`` — one quarantined design; resumed runs
      keep it quarantined instead of re-paying the failure.
    """

    def __init__(self, path):
        self.path = str(path)
        self._records: Optional[list[dict]] = None

    # ---------------- read side ----------------
    def load(self) -> list[dict]:
        """All records currently published, oldest first.

        Missing file -> [].  Undecodable lines are skipped (publishes are
        atomic, so they cannot normally occur; skipping keeps a journal
        on a non-atomic filesystem readable rather than fatal).
        """
        if not os.path.exists(self.path):
            return []
        records = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        return records

    def completed(self) -> dict:
        """fingerprint -> record for every journaled evaluation (scored
        and quarantined alike)."""
        return {
            r["fp"]: r
            for r in self.load()
            if r.get("kind") in ("point", "failure") and "fp" in r
        }

    # ---------------- write side ----------------
    def begin(self, meta: dict, resume: bool) -> dict:
        """Open the journal for a run; returns ``completed()``.

        A fresh path publishes the meta header and returns {} (with or
        without ``resume`` — resuming from nothing is a fresh start).  An
        existing journal requires ``resume=True`` (never silently clobber
        completed work) and a matching header: mismatched seed / epochs /
        search means the journal describes a *different* run, and
        resuming it would silently mix incompatible evaluations.
        """
        existing = self.load()
        if existing and not resume:
            raise ValueError(
                f"journal {self.path!r} already exists with "
                f"{len(existing) - 1} record(s); pass resume=True to "
                "continue it, or point at a fresh path"
            )
        if existing:
            head = existing[0]
            if head.get("kind") != "meta":
                raise ValueError(
                    f"journal {self.path!r} has no meta header — not an "
                    "explore journal?"
                )
            for key, want in meta.items():
                have = head.get(key)
                if have != want:
                    raise ValueError(
                        f"journal {self.path!r} was written by a run with "
                        f"{key}={have!r}; this run has {key}={want!r} — "
                        "resume requires an identical run configuration"
                    )
            self._records = existing
        else:
            self._records = [
                {"kind": "meta", "version": JOURNAL_VERSION, **meta}
            ]
            self._publish()
        return {
            r["fp"]: r
            for r in self._records
            if r.get("kind") in ("point", "failure") and "fp" in r
        }

    def append(self, records: Sequence[dict]) -> None:
        """Append records and publish atomically (write-then-rename)."""
        if not records:
            return
        if self._records is None:
            self._records = self.load()
        self._records.extend(records)
        self._publish()

    def _publish(self) -> None:
        # write-then-rename: full content to a temp file, fsync,
        # atomic rename — a kill at any instant leaves either the old or
        # the new journal, never a torn one
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for rec in self._records:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
