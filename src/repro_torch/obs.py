"""The port's in-memory tracer: spans and counters at the layer boundaries
of the three TNN paths (the serving service, the design sweep and the
single column) and of LM serving (``launch/serve.py`` and the models).

Off by default.  With tracing off a boundary costs the one check of the
module-global ``ON``: no clock read, no allocation, no device
synchronisation.  ``span`` then returns one shared no-op object,
``now`` and ``mark`` return 0.0, and ``record``, ``count`` and ``request``
return at once.  A caller that builds attributes or loops over requests
for the tracer guards that work with ``if obs.ON``.

With tracing on:

* a span is ``(name, t0, t1, parent, attrs)`` on ``time.perf_counter()``
  (the clock the service's own timings read); ``parent`` is the index of
  the span open when it began (-1: none), ``attrs`` a small tuple (request
  ids, bucket index, designs in the bucket, the envelope).  ``span`` is a
  context manager that reads the clock at both ends unless the caller
  hands it a reading it took anyway (``t0=``, ``.end(t1)``); ``record``
  adds a finished span from two such readings, and ``now`` / ``mark``
  time a stage of straight-line code without a ``with`` block (``now``
  reads the clock only while tracing is on, ``mark`` ends a stage there
  and returns the reading that starts the next);
* a counter is an integer that ``count`` adds to;
* ``request`` keeps one record a served, shed or failed request:
  ``(rid, t_admitted, t_dispatched, t_done, status)``;
* ``snapshot`` also reports, per CUDA kernel, the launches, ``nvcc``
  builds and library binds between ``enable`` and ``disable`` (or now);
* ``device_span`` is a span that also records a pair of CUDA events on
  the current stream at its ends; ``snapshot`` resolves them into the
  device time between the two (``device_ms``, by span index).

Nothing synchronises the device for the tracer: a span around an
asynchronous launch times the launch, and device time lands in the span
that waits for it (a ``device_span``'s events are read only at
``snapshot``, after the caller's own synchronisation).  Nothing is
written to disk; the caller takes ``snapshot()``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

# the one check every boundary makes; flipped by enable() / disable()
ON = False

# Finished spans are tuples of numbers, strings and tuples of those: the
# cyclic garbage collector stops tracking such a tuple within a pass a
# level of nesting, so the spans of a long traced window add nothing to
# its full passes (with a list a span, which stays tracked, those passes
# ran again and again in a traced serving window and its p95 rose by a
# sixth on an H100).  The slot of an open span holds None until it ends.
_spans: list = []      # (name, t0, t1, parent, attrs)
_stack: list = []      # open spans, innermost last
_counters: dict = {}
_requests: list = []   # (rid, t_admitted, t_dispatched, t_done, status)
_kernels: dict = {}    # kernel name -> [counts at enable(), at disable()]
_events: list = []     # (span index, start event, end event) of device spans


class _Noop:
    """The span tracing-off boundaries get: one object, shared."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, t1: float, attrs: Optional[tuple] = None) -> None:
        pass


NOOP = _Noop()


class _Open:
    __slots__ = ("i", "name", "t0", "t1", "parent", "attrs", "start")

    def __init__(self, i: int, name: str, t0: float, parent: int,
                 attrs: tuple):
        self.i, self.name, self.t0, self.t1 = i, name, t0, None
        self.parent, self.attrs, self.start = parent, attrs, None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter() if self.t1 is None else self.t1
        if self.start is not None:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _events.append((self.i, self.start, end))
        if _stack and _stack[-1] is self:
            _stack.pop()
            _spans[self.i] = (self.name, self.t0, t1, self.parent, self.attrs)
        return False

    def end(self, t1: float, attrs: Optional[tuple] = None) -> None:
        """End the span at ``t1``, a reading the caller took itself, and
        give it ``attrs`` where they were not known when it began."""
        self.t1 = t1
        if attrs is not None:
            self.attrs = attrs


def _kernel_counts() -> dict:
    from repro_torch.kernels import build

    return {k.name: (k.launches, k.builds, k.binds) for k in build.KERNELS}


def enable() -> None:
    """Start tracing; kernel counts are taken from here."""
    global ON
    if not ON:
        for name, c in _kernel_counts().items():
            _kernels[name] = [c, None]
    ON = True


def disable() -> None:
    """Stop tracing; what was recorded stays until ``reset``."""
    global ON
    if ON:
        for name, c in _kernel_counts().items():
            if name in _kernels:
                _kernels[name][1] = c
    ON = False


@contextlib.contextmanager
def paused():
    """Tracing off inside the block, as it was after it: for work that is
    recorded once and replayed (a CUDA graph's capture), whose spans and
    counters the replaying caller records instead."""
    global ON
    was, ON = ON, False
    try:
        yield
    finally:
        ON = was


def reset() -> None:
    """Drop every span, counter, request record and kernel count."""
    _spans.clear()
    _stack.clear()
    _counters.clear()
    _requests.clear()
    _kernels.clear()
    _events.clear()


def span(name: str, attrs: tuple = (), t0: Optional[float] = None):
    """A span from now (or ``t0``) to the end of the ``with`` block (or the
    reading passed to ``.end``), child of the innermost open span."""
    if not ON:
        return NOOP
    o = _Open(len(_spans), name, time.perf_counter() if t0 is None else t0,
              _stack[-1].i if _stack else -1, attrs)
    _spans.append(None)
    _stack.append(o)
    return o


def device_span(name: str, attrs: tuple = (), device=None):
    """A span, as ``span``, that on a CUDA ``device`` also records a CUDA
    event on the current stream where it begins and one where it ends;
    ``snapshot`` gives the device time between them (``device_ms``).
    Anywhere else, or with tracing off, a plain span (or none)."""
    if not ON:
        return NOOP
    o = span(name, attrs)
    if device is not None and getattr(device, "type", device) == "cuda":
        import torch

        o.start = torch.cuda.Event(enable_timing=True)
        o.start.record()
    return o


def record(name: str, t0: float, t1: float, attrs: tuple = ()) -> None:
    """A finished span from two readings the caller took, child of the
    innermost open span."""
    if ON:
        _spans.append((name, t0, t1, _stack[-1].i if _stack else -1, attrs))


def now() -> float:
    """The clock while tracing is on, else 0.0 (no reading)."""
    return time.perf_counter() if ON else 0.0


def mark(name: str, t0: float, attrs: tuple = ()) -> float:
    """A finished span from ``t0`` (a ``now`` or the caller's own reading)
    to now, child of the innermost open span; returns its end, which
    starts the next stage (0.0 with tracing off)."""
    if not ON:
        return 0.0
    t1 = time.perf_counter()
    _spans.append((name, t0, t1, _stack[-1].i if _stack else -1, attrs))
    return t1


def count(name: str, n: int = 1) -> None:
    if ON:
        _counters[name] = _counters.get(name, 0) + n


def request(rid: int, t_admitted: float, t_dispatched: float, t_done: float,
            status: str) -> None:
    """One request's record: admitted to its queue, its batch dispatched,
    done; ``status`` is ``'served'``, ``'shed'`` or ``'failed'``."""
    if ON:
        _requests.append((rid, t_admitted, t_dispatched, t_done, status))


def snapshot() -> dict:
    """Copies of what was recorded: ``spans`` [(name, t0, t1, parent,
    attrs)] in the order they began or were recorded (t1 None while
    open), ``counters``,
    ``requests``, ``kernels`` {name: {launches, builds, binds}} counted
    inside the traced interval, and ``device_ms`` {span index: ms} of the
    ended device spans (this waits for their end events)."""
    now = _kernel_counts() if _kernels else {}
    kernels = {}
    for name, (c0, c1) in _kernels.items():
        c1 = c1 if c1 is not None and not ON else now[name]
        kernels[name] = dict(zip(("launches", "builds", "binds"),
                                 (b - a for a, b in zip(c0, c1))))
    spans = list(_spans)
    for o in _stack:
        spans[o.i] = (o.name, o.t0, None, o.parent, o.attrs)
    return {
        "spans": spans,
        "counters": dict(_counters),
        "requests": list(_requests),
        "kernels": kernels,
        "device_ms": {i: _elapsed(s, e) for i, s, e in _events},
    }


def _elapsed(start, end) -> float:
    end.synchronize()
    return start.elapsed_time(end)
