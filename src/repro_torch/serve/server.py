"""The predict server: synchronous submit API over a threaded dispatcher
(the port of ``repro.serve.server``).

``PredictServer.submit(name, payload)`` enqueues one request and returns a
:class:`PredictFuture`; a dispatcher (either the background thread started
by ``start()``/``serve_forever()``, or a deterministic synchronous
``pump()`` — what the tests and ``chip_smoke.py`` drive) drains the queue,
groups requests by (model, block format), micro-batches each group into the
model's declared geometry buckets (``repro_torch.serve.batching``) and
launches the warmed predict plan through ``resilience.run_resilient`` — so
plan-level transients retry and OOM walks the fused -> eager -> einsum
ladder exactly as everywhere else in the package.

Above the plan layer sits the SERVING recovery ladder, provable through
the ``serve_dispatch`` fault site (see ``resilience.inject``):

1. a transient at dispatch retries the whole batched dispatch (bounded by
   the policy's ``max_retries``; ``resilience.execute.classify_error``
   decides what is transient);
2. anything else — OOM the plan ladder could not absorb, a deterministic
   error, retry exhaustion — SHEDS BATCHING: the batch's requests re-serve
   one by one through unbatched eager ``predict`` at natural geometry (the
   same kernels, on the same device), so one poisoned request fails alone
   instead of failing its neighbours;
3. a request that still fails gets the error on its future; the rest of
   the batch completes.

Results are host NumPy ``(r, 1)`` arrays: a batch is collected on its
device and copied to the host once.  Every request updates the
``serve.stats()`` counters (queue depth, batch sizes, cache hits,
sheds/retries/fallbacks) and the per-request latency reservoir.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch._faults import fire as _fire
from repro_torch.estimators.base import _host
from repro_torch.obs import tracing as _tracing
from repro_torch.resilience.execute import (RetryPolicy, TRANSIENT,
                                            classify_error, run_resilient)
from repro_torch.serve import batching as _batching
from repro_torch.serve import stats as _stats
from repro_torch.serve.compilecache import record_cache_outcome
from repro_torch.serve.registry import ModelRegistry, ServedModel


class PredictFuture:
    """Handle for one submitted request; ``result()`` blocks until served."""

    __slots__ = ("_event", "_value", "_error", "submitted_at", "latency")

    def __init__(self):
        self._event = threading.Event()
        self._value: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self.submitted_at = time.perf_counter()
        self.latency: Optional[float] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The ``(r, 1)`` prediction rows for this request (blocks)."""
        if not self._event.wait(timeout):
            raise TimeoutError("prediction not ready")
        if self._error is not None:
            raise self._error
        return self._value

    def _finish(self, value: np.ndarray) -> None:
        self.latency = time.perf_counter() - self.submitted_at
        self._value = value
        _stats.record_latency(self.latency)
        _stats.bump("responses")
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self.latency = time.perf_counter() - self.submitted_at
        self._error = error
        _stats.bump("failures")
        self._event.set()


@dataclasses.dataclass
class _Pending:
    model: ServedModel
    payload: object
    n_rows: int
    fmt: str
    future: PredictFuture


class PredictServer:
    """Micro-batching predict server over a :class:`ModelRegistry`.

    Synchronous API: ``submit`` returns a future, ``pump()`` serves
    everything currently queued (deterministic — what tests drive), and
    ``start()``/``serve_forever()`` run the same loop on a thread for
    concurrent callers.  ``policy`` is the shared
    :class:`~repro_torch.resilience.execute.RetryPolicy` for both the plan
    executions and the dispatch-level transient retry.
    """

    def __init__(self, registry: ModelRegistry,
                 policy: Optional[RetryPolicy] = None,
                 unbatched_fallback: bool = True):
        self.registry = registry
        self.policy = policy or RetryPolicy()
        self.unbatched_fallback = unbatched_fallback
        self._queue: "deque[_Pending]" = deque()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- request intake ------------------------------------------------------
    def submit(self, name: str, payload, *,
               version: Optional[int] = None) -> PredictFuture:
        """Enqueue one request (rows for ``name``) and return its future.
        Payload validation happens here — a malformed request raises at
        submit instead of poisoning a batch."""
        with _tracing.span("serve.submit", model=name):
            model = self.registry.get(name, version)
            payload, n, fmt = model.normalize(payload)
            pend = _Pending(model=model, payload=payload, n_rows=n, fmt=fmt,
                            future=PredictFuture())
            with self._wake:
                self._queue.append(pend)
                _stats.bump("requests")
                _stats.observe_queue_depth(len(self._queue))
                self._wake.notify()
            return pend.future

    # -- dispatch loop -------------------------------------------------------
    def pump(self) -> int:
        """Serve everything queued right now, synchronously; returns the
        number of requests completed.  The dispatcher thread calls this in
        a loop; tests call it directly for deterministic scheduling."""
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
            _stats.observe_queue_depth(0)
        if not pending:
            return 0
        groups: Dict[Tuple[int, str], List[_Pending]] = {}
        for p in pending:
            groups.setdefault((id(p.model), p.fmt), []).append(p)
        for (_, fmt), group in groups.items():
            self._dispatch_group(group[0].model, fmt, group)
        return len(pending)

    def serve_forever(self, poll: float = 0.05) -> None:
        """Run the dispatch loop until :meth:`stop` (blocking)."""
        while not self._stop.is_set():
            with self._wake:
                if not self._queue:
                    self._wake.wait(timeout=poll)
            self.pump()

    def start(self) -> "PredictServer":
        """Run :meth:`serve_forever` on a daemon thread."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="repro-serve", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self) -> "PredictServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- serving internals ---------------------------------------------------
    def _dispatch_group(self, model: ServedModel, fmt: str,
                        group: List[_Pending]) -> None:
        """Chunk one (model, format) group by the largest declared bucket
        and serve each chunk batched; oversized single requests go straight
        to the unbatched path (there is no bucket that fits them)."""
        cap = model.spec.max_rows(fmt)
        chunk: List[_Pending] = []
        rows = 0
        for p in group:
            if p.n_rows > cap:
                _stats.bump("bucket_fallbacks")
                self._serve_single(model, [p])
                continue
            if chunk and rows + p.n_rows > cap:
                self._serve_chunk(model, fmt, chunk)
                chunk, rows = [], 0
            chunk.append(p)
            rows += p.n_rows
        if chunk:
            self._serve_chunk(model, fmt, chunk)

    def _serve_chunk(self, model: ServedModel, fmt: str,
                     chunk: List[_Pending]) -> None:
        outs = None
        attempts = 0
        shed = False
        while True:
            try:
                # one span per dispatch ATTEMPT — transient retries each
                # leave their own (error-tagged) span in the trace
                with _tracing.span("serve.dispatch", mode="batched",
                                   model=model.name, requests=len(chunk),
                                   attempt=attempts):
                    _fire("serve_dispatch", mode="batched", model=model.name,
                          requests=len(chunk))
                    outs = self._predict_batched(model, fmt, chunk)
                break
            except Exception as exc:                     # noqa: BLE001
                if classify_error(exc) == TRANSIENT \
                        and attempts < self.policy.max_retries:
                    attempts += 1
                    _stats.bump("dispatch_retries")
                    time.sleep(self.policy.delay(attempts))
                    continue
                if not self.unbatched_fallback:
                    for p in chunk:
                        p.future._fail(exc)
                    return
                shed = True
                break
        if shed:
            _stats.bump("batch_sheds")
        if outs is None:                  # shed OR no bucket fit the batch
            if not shed:
                _stats.bump("bucket_fallbacks")
            self._serve_single(model, chunk)
            return
        _stats.bump("batches")
        _stats.bump("batched_requests", len(chunk))
        for p, rows in zip(chunk, outs):
            p.future._finish(rows)

    def _predict_batched(self, model: ServedModel, fmt: str,
                         chunk: List[_Pending]) -> Optional[List[np.ndarray]]:
        """One padded, bucket-shaped plan launch for the whole chunk ->
        per-request result rows; None when no declared bucket fits (size or
        bcoo nse overflow) and the caller should fall back."""
        total = sum(p.n_rows for p in chunk)
        bucket = model.spec.bucket_for(total, fmt)
        if bucket is None:
            return None
        with _tracing.span("serve.batch", model=model.name,
                           requests=len(chunk), rows=total):
            x = _batching.assemble([p.payload for p in chunk], bucket)
        if x is None:                                   # nse overflow
            return None
        if model.plan_backed:
            plan, warmed = model.cache.plan_for(x, bucket)
            out = run_resilient(plan, policy=self.policy)
            record_cache_outcome(warmed, len(chunk))
        else:
            out = model.estimator.predict(x)
            _stats.bump("eager_requests", len(chunk))
        with _tracing.span("serve.slice", requests=len(chunk)):
            rows = _host(out)                      # one copy to the host
            return _batching.split_rows(rows, [p.n_rows for p in chunk])

    def _serve_single(self, model: ServedModel,
                      chunk: List[_Pending]) -> None:
        """Unbatched fallback: each request served alone at natural
        geometry, transient-retried, failures isolated per request."""
        for p in chunk:
            attempts = 0
            while True:
                try:
                    with _tracing.span("serve.dispatch", mode="single",
                                       model=model.name, requests=1,
                                       attempt=attempts):
                        _fire("serve_dispatch", mode="single",
                              model=model.name, requests=1)
                        rows = model.predict_direct(p.payload)
                    _stats.bump("single_dispatches")
                    p.future._finish(rows)
                    break
                except Exception as exc:                 # noqa: BLE001
                    if classify_error(exc) == TRANSIENT \
                            and attempts < self.policy.max_retries:
                        attempts += 1
                        _stats.bump("dispatch_retries")
                        time.sleep(self.policy.delay(attempts))
                        continue
                    p.future._fail(exc)
                    break
