"""``repro_torch.obs`` — telemetry: tracing, metrics, profiling (the port of
``repro.obs``).

* **tracing** (:mod:`repro_torch.obs.tracing`) — ``span``/``traced``,
  off by default and allocation-free while off; ``trace_to(path)`` exports
  Chrome trace-event JSON, ``summary()`` renders the aggregated tree;
* **metrics** (:mod:`repro_torch.obs.metrics`) — the process-wide
  :data:`registry` of Counter/Gauge/Histogram objects that
  ``plan.cache_stats()``, ``resilience.stats()`` and ``serve.stats()`` are
  views over; ``snapshot()``/``reset_all()``;
* **profiling** (:mod:`repro_torch.obs.profiler`) — ``profile(plan)`` pairs
  each plan node's measured time and bytes with the ``costmodel`` laws.

``tracing`` and ``metrics`` import nothing from ``repro_torch``; the
profiler pulls in the plan layer, so it is loaded on the first
:func:`profile` call.
"""

from __future__ import annotations

from repro_torch.obs import metrics, tracing
from repro_torch.obs.metrics import (Counter, CounterGroup, Gauge, Histogram,
                                     MetricsRegistry, registry)
from repro_torch.obs.tracing import (Span, clear, disable, enable, enabled,
                                     events, recording, span,
                                     span_allocations, summary, trace_to,
                                     traced)


def snapshot(prefix=None):
    """Flat ``{dotted_name: value}`` over every registered metric."""
    return registry.snapshot(prefix)


def reset_all() -> None:
    """Zero every metric and drop the trace buffer (counters only: the plan
    caches are storage, not telemetry, and are left alone)."""
    registry.reset_all()
    tracing.clear()


def profile(target, **kwargs):
    """Predicted-vs-measured cost report for a plan (or anything coercible
    to one).  See :func:`repro_torch.obs.profiler.profile`."""
    from repro_torch.obs.profiler import profile as _profile
    return _profile(target, **kwargs)


__all__ = [
    "Counter", "CounterGroup", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "clear", "disable", "enable", "enabled", "events", "metrics",
    "profile", "recording", "registry", "reset_all", "snapshot", "span",
    "span_allocations", "summary", "trace_to", "traced", "tracing",
]
