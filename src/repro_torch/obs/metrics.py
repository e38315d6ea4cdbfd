"""Typed metrics in one process-wide registry (the port of
``repro.obs.metrics``, copied: it imports nothing of either package).

:class:`Counter`, :class:`Gauge` and :class:`Histogram` objects are
registered by dotted name (``"plan.hits"``, ``"serve.latency_s"``) in the
process-wide :data:`registry`, every mutation taken under one lock: the
predict server's worker thread bumps them.  :class:`CounterGroup` is a
family under one prefix whose ``as_dict()`` keeps insertion order and plain
``int`` values, so ``plan.cache_stats()``, ``resilience.stats()`` and
``serve.stats()`` read as the reference's; :meth:`Histogram.summary` is
nearest-rank over a bounded ``deque(maxlen=...)`` reservoir.  This module
imports nothing from ``repro_torch``, so every layer may import it.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterable, List, Optional


class Counter:
    """Monotonic (until reset) integer counter with a locked increment."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Point-in-time value (queue depths, watermarks)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value = 0
        self._lock = lock

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def set_max(self, value) -> None:
        """High-watermark update (atomic compare-and-set)."""
        with self._lock:
            if value > self._value:
                self._value = value

    @property
    def value(self):
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Histogram:
    """Bounded-reservoir distribution (the serve latency deque, made a
    type).  ``summary()`` reports nearest-rank percentiles with the exact
    index math ``serve.latency_summary()`` always used, so migrating the
    latency reservoir here changes no reported number."""

    __slots__ = ("name", "_values", "_lock")

    def __init__(self, name: str, lock: threading.Lock, maxlen: int = 4096):
        self.name = name
        self._values: deque = deque(maxlen=maxlen)
        self._lock = lock

    def observe(self, value: float) -> None:
        with self._lock:
            self._values.append(value)

    def values(self) -> List[float]:
        with self._lock:
            return list(self._values)

    @staticmethod
    def _percentile(sorted_vals: List[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
        return sorted_vals[i]

    def summary(self, scale: float = 1.0) -> Dict[str, float]:
        """``{count, p50, p99, mean, max}`` over the reservoir, each value
        multiplied by ``scale`` (serve passes 1e3 for milliseconds)."""
        with self._lock:
            vals = sorted(self._values)
        if not vals:
            return {"count": 0, "p50": 0.0, "p99": 0.0,
                    "mean": 0.0, "max": 0.0}
        return {
            "count": len(vals),
            "p50": self._percentile(vals, 0.50) * scale,
            "p99": self._percentile(vals, 0.99) * scale,
            "mean": sum(vals) / len(vals) * scale,
            "max": vals[-1] * scale,
        }

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


class MetricsRegistry:
    """All metrics of the process, by dotted name.  ``counter``/``gauge``/
    ``histogram`` are get-or-create (idempotent across reloads and repeated
    ``CounterGroup`` construction); ``snapshot()`` flattens everything into
    one JSON-able dict."""

    def __init__(self):
        self._lock = threading.Lock()     # shared by every metric
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self._lock, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str, maxlen: int = 4096) -> Histogram:
        return self._get_or_create(name, Histogram, maxlen)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, object]:
        """Flat ``{name: value}`` over every registered metric (histograms
        contribute their ``summary()`` dict), optionally filtered to one
        dotted ``prefix`` (``"plan"``, ``"serve"``...)."""
        out: Dict[str, object] = {}
        for name in self.names():
            if prefix and not name.startswith(prefix + "."):
                continue
            m = self._metrics[name]
            out[name] = (m.summary() if isinstance(m, Histogram)
                         else m.value)
        return out

    def reset_all(self, prefix: Optional[str] = None) -> None:
        for name in self.names():
            if prefix and not name.startswith(prefix + "."):
                continue
            self._metrics[name].reset()


#: the process-wide registry every subsystem registers into
registry = MetricsRegistry()


class CounterGroup:
    """An ordered family of counters under one prefix — the migration shim
    for the former module-level ``_STATS`` dicts.  ``inc`` is the locked
    write path (the thread-safety fix for resilience's bare ``+=``);
    ``as_dict()`` reproduces the old ``dict(_STATS)`` snapshot bit for bit,
    insertion order included."""

    __slots__ = ("_names", "_counters")

    def __init__(self, prefix: str, names: Iterable[str],
                 reg: MetricsRegistry = None):
        reg = reg or registry
        self._names = tuple(names)
        self._counters = {n: reg.counter(f"{prefix}.{n}")
                          for n in self._names}

    def inc(self, name: str, n: int = 1) -> None:
        self._counters[name].inc(n)

    def __getitem__(self, name: str) -> int:
        return self._counters[name].value

    def as_dict(self) -> Dict[str, int]:
        return {n: self._counters[n].value for n in self._names}

    def reset(self) -> None:
        for c in self._counters.values():
            c.reset()
