"""Deterministic fault injection at the ``fused_column`` seam.

The streaming service (``serve.service``) looks its two entry points up
through the module at every call: ``fused_column.fit_scan_padded`` for
the re-fit and ``fused_column.assign_padded`` for the batched
assignment.  Replace either with a plain callable and every fused fit or
assignment in the process goes through it, so a wrapper installed here
intercepts the service, and the sweep, alike.

Each injector below takes the original entry point and returns a
wrapper that reproduces one concrete failure mode deterministically:

* ``fail_on_lowering``  — a lowering-specific kernel failure (the
  ``'cuda'`` kernels are down, the ``'reference'`` lowering still works);
* ``fail_on_threshold`` — one poisoned *design* detonates any batch it
  rides, keyed by its threshold (distinct thresholds make a design
  individually addressable inside a shared envelope);
* ``fail_on_volley``    — one poisoned *request* detonates its batch,
  keyed by its encoded volley (mid-batch crash);
* ``nan_poison``        — the call "succeeds" but returns NaN-poisoned
  weights (a numerically broken re-fit);
* ``slow_call``         — a stalled call: correct results, pathologic
  latency (trips watchdog budgets deterministically);
* ``fail_always``       — the entry point is simply down.

Install a wrapper with ``monkeypatch.setattr`` in tests, or with the
``injected(...)`` context manager outside pytest.  All injected errors
are ``InjectedFault`` (a ``RuntimeError``) whose message contains
``"injected fault"``.

The port's copy of the JAX package's ``testing/faults.py``: the same six
injectors; thresholds and volleys are compared on the host.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


class InjectedFault(RuntimeError):
    """An error raised by this harness — never by real code paths."""


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fail_on_lowering(orig, lowerings=("cuda",)):
    """Fail whenever the call targets one of ``lowerings`` — other rungs
    pass through, so the degradation ladder has somewhere to land."""

    def wrapper(*args, **kwargs):
        low = kwargs.get("lowering", "reference")
        if low in lowerings:
            raise InjectedFault(f"injected fault: lowering {low!r} down")
        return orig(*args, **kwargs)

    return wrapper


def fail_on_threshold(orig, threshold, lowerings=None):
    """Fail whenever the poisoned design's threshold rides the batch (at
    one of ``lowerings``, or at any lowering when ``None``) — the
    per-design poison for shared-envelope quarantine tests."""

    def wrapper(w, xs, thresholds, *args, **kwargs):
        low = kwargs.get("lowering", "reference")
        if (lowerings is None or low in lowerings) and np.any(
            np.isclose(_host(thresholds), threshold)
        ):
            raise InjectedFault("injected fault: poisoned design present")
        return orig(w, xs, thresholds, *args, **kwargs)

    return wrapper


def fail_on_volley(orig, volley):
    """Fail whenever the encoded ``volley`` rides ``xs`` in any lane —
    the per-request poison for mid-batch quarantine tests."""
    volley = _host(volley)

    def wrapper(w, xs, *args, **kwargs):
        if (_host(xs) == volley).all(axis=-1).any():
            raise InjectedFault("injected fault: poisoned volley")
        return orig(w, xs, *args, **kwargs)

    return wrapper


def nan_poison(orig):
    """Return the original result with one NaN planted in it — a re-fit
    that 'succeeds' with corrupt weights (the caller's finite-weights
    guard must catch it)."""

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs).to(torch.float32).clone()
        out.view(-1)[0] = float("nan")
        return out

    return wrapper


def slow_call(orig, delay_s):
    """Correct results, ``delay_s`` extra wall time — a stalled call
    for watchdog-budget tests."""

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        time.sleep(delay_s)
        return out

    return wrapper


def fail_always(orig=None, detail="executable down"):
    """Unconditional failure (``orig`` accepted and ignored, so the same
    callable works bare or through ``injected``)."""

    def wrapper(*args, **kwargs):
        raise InjectedFault(f"injected fault: {detail}")

    return wrapper


@contextlib.contextmanager
def injected(name, make_wrapper, *args, module=None, **kwargs):
    """Install ``make_wrapper(original, *args, **kwargs)`` over
    ``fused_column.<name>`` (or ``module.<name>``) for the duration of
    the block — the non-pytest counterpart of ``monkeypatch.setattr``."""
    if module is None:
        from repro_torch.kernels import fused_column as module  # noqa: PLW0127
    orig = getattr(module, name)
    setattr(module, name, make_wrapper(orig, *args, **kwargs))
    try:
        yield orig
    finally:
        setattr(module, name, orig)
