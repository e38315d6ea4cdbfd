"""Counters in one process-wide registry (the subset of ``repro.obs.metrics``
the port uses).

:class:`Counter` objects are registered by dotted name (``"gemm.dispatch_cuda"``)
in :data:`registry`, every increment taken under one lock.
:class:`CounterGroup` is a family under one prefix.  This module
imports nothing from ``repro_torch``, so every layer may import it.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional


class Counter:
    """Monotonic integer counter with a locked increment."""

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


class MetricsRegistry:
    """All counters of the process, by dotted name.  ``counter`` is
    get-or-create; ``snapshot()`` flattens everything into one dict."""

    def __init__(self):
        self._lock = threading.Lock()     # shared by every metric
        self._metrics: Dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Counter(name, self._lock)
                self._metrics[name] = m
            return m

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, int]:
        """Flat ``{name: value}``, optionally filtered to one dotted prefix."""
        with self._lock:
            names = sorted(self._metrics)
        return {name: self._metrics[name].value for name in names
                if not prefix or name.startswith(prefix + ".")}


#: the process-wide registry every layer registers into
registry = MetricsRegistry()


class CounterGroup:
    """A family of counters under one prefix, registered in :data:`registry`."""

    __slots__ = ("_counters",)

    def __init__(self, prefix: str, names: Iterable[str]):
        self._counters = {n: registry.counter(f"{prefix}.{n}") for n in names}

    def inc(self, name: str, n: int = 1) -> None:
        self._counters[name].inc(n)

    def __getitem__(self, name: str) -> int:
        return self._counters[name].value
