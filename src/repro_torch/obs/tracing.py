"""Trace spans (the subset of ``repro.obs.tracing`` the port uses).

Tracing is off by default; ``span(...)`` then returns one shared no-op
singleton, so an instrumented site pays a single flag check.  When enabled,
each ``with span(name, **attrs):`` block records one Chrome trace-event
"complete" record (``ph: "X"``, microsecond ``ts``/``dur``) into a locked
buffer; :func:`recording` hands back the events of its block.  Span names used by the port:
``fit.loop`` (a whole Lloyd loop) and ``fit.iteration`` (one pass of it).
A span times the host: a site that wants device time synchronises inside
the span (the K-means loop does, once per iteration, to test convergence).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, Optional

_lock = threading.Lock()
_enabled = False
_events: List[dict] = []


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


class _NullSpan:
    """The disabled path: one shared, stateless span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Span:
    """One timed block -> one Chrome "X" event."""

    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: Optional[dict] = None):
        self.name = name
        self.args = args or {}
        self._t0 = 0

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_ns = time.perf_counter_ns() - self._t0
        evt = {"name": self.name, "cat": self.name.split(".", 1)[0],
               "ph": "X", "ts": self._t0 / 1e3, "dur": dur_ns / 1e3,
               "pid": os.getpid(), "tid": threading.get_ident()}
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        if self.args:
            evt["args"] = {k: _jsonable(v) for k, v in self.args.items()}
        with _lock:
            if _enabled:
                _events.append(evt)
        return False


def span(name: str, **attrs):
    """``with span("fit.loop", estimator="KMeans"): ...``"""
    if not _enabled:
        return _NULL_SPAN
    return Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Enable tracing for the block; yields the list that receives the
    events captured inside it."""
    was_enabled = _enabled
    with _lock:
        start = len(_events)
    captured: List[dict] = []
    enable()
    try:
        yield captured
    finally:
        if not was_enabled:
            disable()
        with _lock:
            captured.extend(_events[start:])
            if not was_enabled:      # no enclosing recording wants them
                del _events[start:]
