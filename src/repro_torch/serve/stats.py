"""Request-level serving observability: counters and latency percentiles
(the port of ``repro.serve.stats``).

A view over the ``repro_torch.obs`` registry: every counter is an ``obs``
Counter registered as ``"serve.<name>"``, the queue watermarks are Gauges,
and the bounded per-request latency reservoir is a Histogram
(``"serve.latency_s"``).  ``stats()``/``latency_summary()`` have the
reference's shapes (key order, plain ints, nearest-rank percentiles), so
the steady-state contract reads the same numbers in both packages:
``cache_hits == requests`` for warmed geometries, zero ``batch_sheds``/
``dispatch_retries`` on clean runs, each recovery path bumping exactly its
own counter under injected faults.  Every increment takes the registry
lock: these paths run on ``PredictServer.start()``'s worker thread.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.obs import metrics as _metrics

_COUNTER_NAMES = (
    # request lifecycle
    "requests",            # submitted
    "responses",           # completed successfully
    "failures",            # completed with an error
    # micro-batching
    "batches",             # batched dispatches executed
    "batched_requests",    # requests served via a batched dispatch
    "single_dispatches",   # requests served via the unbatched fallback
    # plan-cache discipline (the zero-recompile acceptance)
    "cache_hits",          # requests whose plan hit a warmed compiled entry
    "cache_misses",        # requests whose plan had to compile at serve time
    "eager_requests",      # requests served by estimators without a plan
    # resilience / degradation
    "bucket_fallbacks",    # no declared bucket fit (size or nse overflow)
    "batch_sheds",         # batched dispatch abandoned -> unbatched path
    "dispatch_retries",    # transient serve_dispatch retries
)

_COUNTERS = _metrics.CounterGroup("serve", _COUNTER_NAMES)
_QUEUE_DEPTH = _metrics.registry.gauge("serve.queue_depth")
_QUEUE_PEAK = _metrics.registry.gauge("serve.queue_depth_peak")
_LATENCY = _metrics.registry.histogram("serve.latency_s", maxlen=4096)


def bump(name: str, n: int = 1) -> None:
    _COUNTERS.inc(name, n)


def observe_queue_depth(depth: int) -> None:
    _QUEUE_DEPTH.set(depth)
    _QUEUE_PEAK.set_max(depth)


def record_latency(seconds: float) -> None:
    _LATENCY.observe(seconds)


def latency_summary() -> Dict[str, float]:
    """p50/p99/mean/max over the latency reservoir, in milliseconds."""
    s = _LATENCY.summary(scale=1e3)
    return {"count": s["count"], "p50_ms": s["p50"], "p99_ms": s["p99"],
            "mean_ms": s["mean"], "max_ms": s["max"]}


def stats() -> Dict[str, object]:
    """Counters since the last :func:`reset_stats`, plus the latency
    summary under ``"latency"`` — the serving analogue of
    ``resilience.stats()`` / ``plan.cache_stats()``."""
    out: Dict[str, object] = _COUNTERS.as_dict()
    out["queue_depth"] = _QUEUE_DEPTH.value
    out["queue_depth_peak"] = _QUEUE_PEAK.value
    out["latency"] = latency_summary()
    return out


def reset_stats() -> None:
    _COUNTERS.reset()
    _QUEUE_DEPTH.reset()
    _QUEUE_PEAK.reset()
    _LATENCY.reset()
