"""Checkpoint / restore with async save and atomic publish.

Layout (one directory per step), the JAX package's:
    <root>/step_<k>.tmp/...   (while writing)
    <root>/step_<k>/manifest.json   + one leaf_<i>.npy per leaf
    <root>/LATEST              (atomic pointer file)

* A tree is nested dicts, lists and tuples of tensors, numpy arrays or
  scalars.  Leaves are ordered as the JAX package orders them (dict keys
  sorted, sequences in order) and named by their path (``"a/0/w"``), so
  either package reads a directory the other wrote.
* ``save`` copies every leaf to host numpy in the calling thread (a
  device tensor is copied to the host there, so the caller may go on
  changing it), then writes on a background thread (``wait()`` joins).
  The directory is renamed into place only after all leaves and the
  manifest are written and the manifest fsynced: a preempted save is
  never mistaken for a complete one.
* ``restore`` returns host numpy arrays, or tensors on the device the
  caller names.
* numpy has no bfloat16: a bf16 tensor is stored as its 16-bit patterns
  (an int16 ``.npy``, ``"bfloat16"`` in the manifest) and restored as a
  bf16 tensor (on the CPU when no device is named).

The port's own copy of the JAX package's ``distributed/checkpoint.py``
(which flattens with JAX's tree utilities).  The streaming service's
live-weight snapshots (``serve.durability``) ride it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree, path: tuple = ()) -> list[tuple[str, Any]]:
    """[(path name, leaf)] in the JAX package's leaf order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, path + (i,))
        return out
    return [("/".join(str(e) for e in path), tree)]


def _unflatten(like, leaves: list):
    """``leaves`` (in ``_flatten`` order) in the structure of ``like``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.cpu().numpy().copy()
    return np.array(x)


def _dtype_name(x, h: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(h.dtype)


class Checkpointer:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------- save ----------------
    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Copy to host memory now, write on a background thread."""
        self.wait()
        flat = _flatten(tree)
        host = [_host(x) for _, x in flat]  # device -> host, in this thread
        spec = {
            "step": step,
            "names": [n for n, _ in flat],
            "dtypes": [_dtype_name(x, h) for (_, x), h in zip(flat, host)],
            "shapes": [list(h.shape) for h in host],
        }

        def write():
            try:
                tmp = os.path.join(self.root, f"step_{step}.tmp")
                final = os.path.join(self.root, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                for i, h in enumerate(host):
                    np.save(os.path.join(tmp, f"leaf_{i}.npy"), h)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(spec, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                latest_tmp = os.path.join(self.root, "LATEST.tmp")
                with open(latest_tmp, "w") as f:
                    f.write(str(step))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(latest_tmp, os.path.join(self.root, "LATEST"))
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # ---------------- introspection / retention ----------------
    def steps(self) -> list:
        """Published snapshot steps, ascending (``.tmp`` directories, an
        in-flight or preempted save, are never listed)."""
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[len("step_"):]))
                except ValueError:
                    continue
        return sorted(out)

    def prune(self, keep: int = 2) -> None:
        """Delete all but the newest ``keep`` published snapshots;
        ``LATEST`` always points at the newest, which is always kept."""
        if keep < 1:
            raise ValueError("prune must keep at least one snapshot")
        self.wait()
        for step in self.steps()[:-keep]:
            shutil.rmtree(
                os.path.join(self.root, f"step_{step}"), ignore_errors=True
            )

    # ---------------- restore ----------------
    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.root, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, like, step: Optional[int] = None, device=None):
        """Restore into the structure of ``like``: ``(tree, step)`` with
        host numpy leaves, or tensors on ``device`` when one is named."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            spec = json.load(f)
        leaves = [x for _, x in _flatten(like)]
        if len(leaves) != len(spec["names"]):
            raise ValueError(
                f"checkpoint has {len(spec['names'])} leaves, template has "
                f"{len(leaves)} — structure changed?"
            )
        loaded = [
            np.load(os.path.join(d, f"leaf_{i}.npy")) for i in range(len(leaves))
        ]
        for h, x in zip(loaded, leaves):
            shape = tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
            if tuple(h.shape) != tuple(shape):
                raise ValueError(f"shape mismatch {h.shape} vs {shape}")

        def leaf(h, dtype: str):
            if device is None and dtype != "bfloat16":
                return h
            t = torch.from_numpy(h)
            if dtype == "bfloat16":
                t = t.view(torch.bfloat16)
            return t if device is None else t.to(device)

        loaded = [leaf(h, d) for h, d in zip(loaded, spec["dtypes"])]
        return _unflatten(like, loaded), step
