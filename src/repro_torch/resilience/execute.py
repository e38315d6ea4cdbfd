"""Guarded plan execution: error classification, retry, degradation ladder
(the port of ``repro.resilience.execute``).

The paper's runtime (PyCOMPSs) absorbs task failures: a died task is
re-submitted and the data structure survives.  Here the resilience lives in
the host program: :func:`run_resilient` wraps a plan execution with

1. **classification** (:func:`classify_error`) — *transient* failures
   (device loss, UNAVAILABLE, interconnect hiccups) are worth retrying;
   *oom* (``torch.cuda.OutOfMemoryError``, RESOURCE_EXHAUSTED) recurs for
   the same program but a cheaper program may fit; everything else is
   *deterministic* and raises at once: programming and numerical errors, a
   sticky CUDA error (an illegal address, an unspecified launch failure, a
   device-side assert: the context is dead and a retry cannot help), and a
   kernel that failed to build or launch (``kernels._build.KernelError``);

2. **retry with exponential backoff** for transients, bounded by
   ``RetryPolicy.max_retries``;

3. **a degradation ladder** for OOM: the plan's cached run (``fused``)
   degrades to a fresh node-by-node run (``eager``), then to that run with
   every dense GEMM's split-K workspace held to the kernel's low-memory cap
   (``einsum``, the reference's name for its last rung:
   ``Plan.execute_eager(backend="einsum")``);

4. an optional **numerical post-condition** (``guard="finite"``) — one
   reduction per root on the clean path, a block-coordinate
   :class:`~repro_torch.resilience.guards.NumericalDivergence` on failure.

Counters (``resilience.*``, ``stats()``) record executions, retries,
degradations, recoveries and guard failures, so tests and ``chip_smoke.py``
can assert the clean path is clean and each recovery path ran; every
attempt is one ``resilience.rung`` span (a failed one carries ``error``).
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import expr as _expr
from repro_torch.core import plan as _plan
from repro_torch.kernels._build import KernelError
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import tracing as _tracing
from repro_torch.resilience import inject as _inject
from repro_torch.resilience.guards import (NumericalDivergence, guard_finite,
                                           poison_block)

# ---------------------------------------------------------------------------
# Error classification
# ---------------------------------------------------------------------------

TRANSIENT = "transient"
OOM = "oom"
DETERMINISTIC = "deterministic"

# message patterns for errors that arrive as opaque runtime exceptions
_OOM_PAT = re.compile(
    r"RESOURCE_EXHAUSTED|out of memory|\bOOM\b|allocat\w* .*exceed", re.I)
_TRANSIENT_PAT = re.compile(
    r"UNAVAILABLE|DEADLINE_EXCEEDED|ABORTED|device.{0,20}(lost|halt|reset)"
    r"|data transfer|socket closed|connection reset", re.I)
# sticky CUDA errors: the context is corrupt, every later call fails too
_STICKY_PAT = re.compile(
    r"illegal memory access|illegal address|illegal instruction"
    r"|misaligned address|unspecified launch failure|device-side assert"
    r"|launch timed out", re.I)

# programming / numerical errors: retrying re-raises the same thing
_DETERMINISTIC_TYPES = (
    NumericalDivergence, ArithmeticError, ValueError, TypeError,
    AssertionError, KeyError, IndexError, AttributeError, NameError,
    NotImplementedError, KernelError,
)


def classify_error(exc: BaseException, default: str = DETERMINISTIC) -> str:
    """``"transient"`` | ``"oom"`` | ``"deterministic"`` for an executor
    exception.

    Injected faults and ``torch.cuda.OutOfMemoryError`` classify by type; a
    failed kernel build or launch and the known programming/numerical error
    types are deterministic; other runtime errors go by their message (a
    sticky CUDA error first: deterministic).  ``default`` decides the
    unknown remainder.
    """
    if isinstance(exc, _inject.OOMError):
        return OOM
    if isinstance(exc, _inject.TransientError):
        return TRANSIENT
    if isinstance(exc, (_inject.CrashError, _inject.IOLoadError)):
        return DETERMINISTIC
    if isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryError)):
        return OOM
    if isinstance(exc, _DETERMINISTIC_TYPES):
        return DETERMINISTIC
    msg = str(exc)
    if _STICKY_PAT.search(msg):
        return DETERMINISTIC
    if _OOM_PAT.search(msg):
        return OOM
    if _TRANSIENT_PAT.search(msg):
        return TRANSIENT
    return default


# ---------------------------------------------------------------------------
# Policy + stats
# ---------------------------------------------------------------------------


#: the OOM degradation ladder, cheapest-to-run first (the reference's names)
LADDER = ("fused", "eager", "einsum")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How hard to try: retries/backoff for transients (OOM always walks
    :data:`LADDER`).  ``backoff`` is the first sleep; each further retry
    multiplies it by ``backoff_factor`` up to ``max_backoff``.
    """

    max_retries: int = 3
    backoff: float = 0.0
    backoff_factor: float = 2.0
    max_backoff: float = 2.0

    def delay(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based)."""
        if self.backoff <= 0.0:
            return 0.0
        return min(self.backoff * self.backoff_factor ** (attempt - 1),
                   self.max_backoff)


_STATS = _metrics.CounterGroup(
    "resilience", ("executions", "retries", "degradations", "recoveries",
                   "guard_failures"))


def stats() -> Dict[str, int]:
    """Counters since the last :func:`reset_stats`: the clean path shows
    zero retries/degradations and each recovery path its own count."""
    return _STATS.as_dict()


def reset_stats() -> None:
    _STATS.reset()


# ---------------------------------------------------------------------------
# Guarded execution
# ---------------------------------------------------------------------------


def _as_plan(exprs: Sequence) -> _plan.Plan:
    if len(exprs) == 1 and isinstance(exprs[0], _plan.Plan):
        return exprs[0]
    roots = [e.expr if isinstance(e, (_expr.LazyDsArray, _expr.LazyScalar))
             else e for e in exprs]
    return _plan.Plan(roots)


def _execute_rung(p: _plan.Plan, rung: str) -> tuple:
    if rung == "fused":
        return p.execute()
    if rung == "eager":
        return p.execute_eager()
    if rung == "einsum":
        return p.execute_eager(backend="einsum")
    raise ValueError(f"unknown ladder rung {rung!r}")


def run_resilient(*exprs, policy: Optional[RetryPolicy] = None,
                  guard: Optional[str] = None):
    """Execute recorded expression(s) (or a prepared
    :class:`~repro_torch.core.plan.Plan`) with retry + degradation + an
    optional numerical guard.

    One expression returns its value; several return a tuple (the
    ``compute`` / ``compute_multi`` shapes).  The clean path is one extra
    function call and a counter bump around ``Plan.execute``: the plan
    caches behave exactly as under ``compute()``.  ``guard="finite"`` arms
    the whole-plan finiteness post-condition.
    """
    if guard not in (None, "finite"):
        raise ValueError(f"unknown guard {guard!r} (want None or 'finite')")
    pol = policy or RetryPolicy()
    p = _as_plan(exprs)
    _STATS.inc("executions")
    rung_i = 0
    attempts = 0
    recovered = False
    while True:
        rung = LADDER[rung_i]
        try:
            # one span per ATTEMPT (failed ones carry an "error" attr), so a
            # trace shows every rung the ladder walked, not just the win
            with _tracing.span("resilience.rung", rung=rung,
                               attempt=attempts):
                out = _execute_rung(p, rung)
            break
        except Exception as exc:                         # noqa: BLE001
            kind = classify_error(exc)
            if kind == TRANSIENT and attempts < pol.max_retries:
                attempts += 1
                _STATS.inc("retries")
                recovered = True
                d = pol.delay(attempts)
                if d > 0.0:
                    time.sleep(d)
                continue
            if kind == OOM and rung_i + 1 < len(LADDER):
                rung_i += 1
                attempts = 0
                _STATS.inc("degradations")
                recovered = True
                continue
            raise
    if recovered:
        _STATS.inc("recoveries")
    # post-op poison (chaos for the guards): armed specs write NaN/Inf into
    # a named block coordinate of a named root
    for spec in _inject.poison_matches("plan_result"):
        from repro_torch.core.dsarray import DsArray
        if spec.root < len(out) and isinstance(out[spec.root], DsArray):
            out = tuple(
                poison_block(v, spec.block, spec.value) if i == spec.root
                else v for i, v in enumerate(out))
    if guard == "finite":
        try:
            guard_finite(*out)
        except NumericalDivergence:
            _STATS.inc("guard_failures")
            raise
    return out[0] if len(out) == 1 else out
