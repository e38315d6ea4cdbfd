"""Structured tracing: spans, Chrome trace-event export, summary tree (the
port of ``repro.obs.tracing``; it imports nothing of either package).

Tracing is off by default; ``span(...)`` then returns one shared
:data:`_NULL_SPAN` singleton (no object, no clock read, no lock), so an
instrumented site pays a single flag check, and :func:`span_allocations`
stays 0.  When enabled, each ``with span(name, **attrs):`` block records
one Chrome trace-event "complete" record (``ph: "X"``, microsecond
``ts``/``dur``, pid/tid, ``args``) into a locked buffer.  A span times the
host: a site that wants device time synchronises inside the span, on the
enabled path only (``plan.launch`` ends after ``torch.cuda.synchronize()``
when the plan ran on the card; the K-means loop syncs once per iteration).

Span names used by the port: ``fit.loop``, ``fit.iteration``,
``plan.optimize``, ``plan.launch``, ``plan.aot_compile``,
``resilience.rung``, ``ingest.load``, ``ingest.chunk``, ``serve.submit``,
``serve.dispatch``, ``serve.batch`` and ``serve.slice``.

Exports: :func:`trace_to` writes the events captured inside its block as
``{"traceEvents": [...]}`` JSON (``chrome://tracing`` / Perfetto);
:func:`recording` hands them back as a list; :func:`summary` renders an
aggregated tree over the dot-separated span names.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Dict, List, Optional

_lock = threading.Lock()
_enabled = False
_events: List[dict] = []       # finished Chrome "X" records, append-only
_span_allocs = 0               # Span objects created since last clear()
_MAX_EVENTS = 1_000_000        # hard buffer bound; beyond it, events drop
_dropped = 0


def enabled() -> bool:
    """True while spans are being recorded (the one flag hot paths check)."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def span_allocations() -> int:
    """Span objects allocated since the last :func:`clear` — the
    disabled-overhead guard asserts this stays 0 with tracing off."""
    return _span_allocs


def clear() -> None:
    """Drop all buffered events and zero the allocation counter."""
    global _span_allocs, _dropped
    with _lock:
        _events.clear()
        _span_allocs = 0
        _dropped = 0


def events() -> List[dict]:
    """A snapshot copy of the buffered trace events."""
    with _lock:
        return list(_events)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


class _NullSpan:
    """The disabled path: one shared, stateless, allocation-free span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class Span:
    """One timed block -> one Chrome "X" event.  Only ever constructed on
    the enabled path; ``set(**attrs)`` attaches late-known attributes
    (e.g. cache-hit status discovered mid-block)."""

    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: Optional[dict] = None):
        global _span_allocs
        _span_allocs += 1
        self.name = name
        self.args = args or {}
        self._t0 = 0

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_ns = time.perf_counter_ns() - self._t0
        evt = {
            "name": self.name,
            "cat": self.name.split(".", 1)[0],
            "ph": "X",
            "ts": self._t0 / 1e3,          # microseconds, trace-event unit
            "dur": dur_ns / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        if self.args:
            evt["args"] = {k: _jsonable(v) for k, v in self.args.items()}
        global _dropped
        with _lock:
            if _enabled:
                if len(_events) < _MAX_EVENTS:
                    _events.append(evt)
                else:
                    _dropped += 1
        return False


def span(name: str, **attrs):
    """``with span("plan.launch", plan=key): ...`` — records one trace
    event when tracing is enabled, returns the shared no-op singleton
    otherwise."""
    if not _enabled:
        return _NULL_SPAN
    return Span(name, attrs)


def traced(fn=None, *, name: Optional[str] = None, **static_attrs):
    """Decorator form: ``@traced`` or ``@traced(name="ingest.load")``.
    The disabled path is a flag check + direct call — no span object."""
    def deco(f):
        label = name or f"{f.__module__.rsplit('.', 1)[-1]}.{f.__qualname__}"

        @functools.wraps(f)
        def wrapper(*a, **kw):
            if not _enabled:
                return f(*a, **kw)
            with Span(label, dict(static_attrs)):
                return f(*a, **kw)
        return wrapper
    if fn is not None:                       # bare @traced
        return deco(fn)
    return deco


@contextlib.contextmanager
def trace_to(path: str):
    """Enable tracing for the block, then write the events captured inside
    it to ``path`` as Chrome trace-event JSON (``chrome://tracing`` /
    Perfetto load it directly).  Nesting under an already-enabled tracer
    captures the inner window without disabling the outer one."""
    was_enabled = _enabled
    with _lock:
        start = len(_events)
    enable()
    try:
        yield
    finally:
        if not was_enabled:
            disable()
        with _lock:
            captured = list(_events[start:])
        with open(path, "w") as f:
            json.dump({"traceEvents": captured, "displayTimeUnit": "ms"},
                      f, indent=1)


@contextlib.contextmanager
def recording():
    """Enable tracing for the block; yields the list that receives the
    events captured inside it (dropped from the buffer afterwards unless an
    enclosing recording wants them)."""
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
            if not was_enabled:
                del _events[start:]


# ---------------------------------------------------------------------------
# Terminal summary tree
# ---------------------------------------------------------------------------


def summary(evts: Optional[List[dict]] = None) -> str:
    """Aggregate spans by their dot-separated names into a tree::

        plan                    12x     38.21ms
          launch                10x     33.90ms
          optimize               2x      4.31ms

    Parent rows aggregate their subtree (a bare ``plan`` span and the
    rollup of ``plan.*`` children both land on the ``plan`` row)."""
    if evts is None:
        evts = events()
    agg: Dict[tuple, List[float]] = {}     # name-path -> [count, total_us]
    for e in evts:
        parts = tuple(e["name"].split("."))
        dur = float(e.get("dur", 0.0))
        for i in range(1, len(parts) + 1):
            node = agg.setdefault(parts[:i], [0, 0.0])
            if i == len(parts):
                node[0] += 1
            node[1] += dur
    if not agg:
        return "(no spans recorded)"
    lines = []
    for path in sorted(agg):
        count, total_us = agg[path]
        label = "  " * (len(path) - 1) + path[-1]
        n = count if count else sum(
            agg[p][0] for p in agg if p[:len(path)] == path)
        lines.append(f"{label:<32}{n:>6}x{total_us / 1e3:>12.2f}ms")
    if _dropped:
        lines.append(f"(+{_dropped} events dropped at buffer bound)")
    return "\n".join(lines)
