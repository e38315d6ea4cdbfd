"""Deterministic fault injection for the plan executor and estimator fits.

Chaos engineering for the reproduction: every recovery path in
``repro_torch.resilience`` (retry, degradation ladder, numerical guards,
checkpoint-resume) must be *provable* in CI, which means faults must be
raisable on demand, at an exact execution point, reproducibly.  This module
is that harness::

    with inject(FaultSpec(kind="transient", site="plan_execute", at=1)):
        out = run_resilient(lazy_expr)      # first launch fails, retry wins

A :class:`FaultSpec` names WHAT fails (``kind``), WHERE (``site`` — a
string the instrumented code passes to :func:`maybe_fire`), and WHEN
(``at``/``times`` count matching arrivals 1-based, or ``p``/``seed`` for a
seeded Bernoulli draw per arrival — both fully deterministic given the
spec, so a failing chaos test replays exactly).  Specs are armed by the
``inject`` context manager onto a module-level stack; instrumented sites
cost one truthy check on that stack when no injection is active, so the
clean path stays zero-overhead.

Sites instrumented across the repo:

====================  =====================================================
site                  where / info keys
====================  =====================================================
``plan_execute``      ``core.plan.Plan.execute`` (``mode="fused"``) and
                      ``Plan.execute_eager`` (``mode="eager"|"einsum"`` —
                      the degradation-ladder rungs)
``gemm_dispatch``     ``kernels.matmul.ops.local_matmul`` per local GEMM
                      (``mode=<resolved backend>`` or ``"sparse"``)
``fit_iteration``     each outer iteration of the checkpointable estimator
                      fits (``estimator=<class name>``, ``iteration=<n>``)
``io_load``           ``core.io`` loaders and ``checkpoint.restore``
                      (``source=<loader name>``); the streaming loaders
                      (``load_txt_file``/``load_svmlight_file``) also fire
                      once per chunk with ``block_row=<i>``, so mid-stream
                      failures are injectable — an abort leaves no partial
                      state (assembly is all-local)
``serve_dispatch``    ``serve.server.PredictServer`` per dispatch attempt
                      (``mode="batched"`` for a micro-batched plan launch,
                      ``mode="single"`` for the shed-batching unbatched
                      fallback; ``model=<name>``, ``requests=<n>``) — every
                      serving recovery path (dispatch retry, batch shed,
                      per-request isolation) is provable through it
====================  =====================================================

Fault kinds and the errors they raise:

* ``"transient"`` — :class:`TransientError` (simulated ``UNAVAILABLE`` /
  device-loss, the class of failure a retry absorbs);
* ``"oom"``       — :class:`OOMError` (simulated ``RESOURCE_EXHAUSTED``;
  for the degradation ladder, ``modes`` restricts firing to the execution
  modes that should keep failing, e.g. ``modes=("fused", "eager")`` forces
  the executor all the way down to the einsum rung);
* ``"crash"``     — :class:`CrashError` (a hard, non-retriable kill — used
  to prove checkpoint-resume of estimator fits);
* ``"io"``        — :class:`IOLoadError` (an ``OSError``: failed load);
* ``"poison"``    — raises nothing: :func:`poison_matches` returns the
  armed specs and the executor writes ``value`` (default NaN) into block
  ``block`` of root ``root`` *after* the op, so the numerical guards can
  prove they localize it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple


class FaultError(RuntimeError):
    """Base class for injected faults (marker: this failure is simulated)."""


class TransientError(FaultError):
    """Simulated transient executor failure (device loss / UNAVAILABLE)."""


class OOMError(FaultError):
    """Simulated RESOURCE_EXHAUSTED: allocation failure at dispatch."""


class CrashError(FaultError):
    """Simulated hard crash: non-retriable, kills the current host loop."""


class IOLoadError(FaultError, OSError):
    """Simulated failed I/O load (checkpoint or data file)."""


_MESSAGES = {
    "transient": ("UNAVAILABLE: injected transient executor error "
                  "(simulated device loss)"),
    "oom": ("RESOURCE_EXHAUSTED: injected out of memory while allocating "
            "(simulated HBM OOM)"),
    "crash": "injected hard crash (simulated process kill)",
    "io": "injected I/O failure (simulated unreadable load)",
}

_ERRORS = {"transient": TransientError, "oom": OOMError,
           "crash": CrashError, "io": IOLoadError}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative description of one injectable fault.

    ``at``/``times`` select arrivals by count (1-based over arrivals that
    match ``site``/``modes``/``where``): fire on arrivals
    ``at .. at+times-1``; ``times=None`` keeps firing from ``at`` onward.
    ``p`` (with ``seed``) instead draws a seeded Bernoulli per matching
    arrival — a deterministic pseudo-random fault schedule.
    """

    kind: str                               # transient|oom|crash|io|poison
    site: Optional[str] = None              # None: any instrumented site
    at: int = 1
    times: Optional[int] = 1
    p: Optional[float] = None
    seed: int = 0
    modes: Tuple[str, ...] = ()             # restrict to execution modes
    where: Optional[Dict[str, object]] = None   # extra info filters
    block: Optional[Tuple[int, int]] = None     # poison: block coordinate
    root: int = 0                               # poison: which plan root
    value: float = math.nan                     # poison: injected value

    def __post_init__(self):
        if self.kind not in ("transient", "oom", "crash", "io", "poison"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "poison" and self.block is None:
            raise ValueError("poison faults need a block=(gi, gj) coordinate")


class _Armed:
    """Runtime state of one armed spec: the deterministic arrival counter
    (and, for ``p`` specs, the seeded draw sequence)."""

    __slots__ = ("spec", "hits", "fired", "_rng")

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.hits = 0
        self.fired = 0
        self._rng = None
        if spec.p is not None:
            import numpy as np
            self._rng = np.random.default_rng(spec.seed)

    def matches(self, site: str, info: Dict[str, object]) -> bool:
        s = self.spec
        if s.site is not None and s.site != site:
            return False
        if s.modes and info.get("mode") not in s.modes:
            return False
        if s.where:
            for k, v in s.where.items():
                if info.get(k) != v:
                    return False
        return True

    def arrive(self) -> bool:
        """Count one matching arrival; True when the fault fires."""
        self.hits += 1
        if self._rng is not None:
            fire = bool(self._rng.random() < self.spec.p)
        else:
            fire = self.hits >= self.spec.at and (
                self.spec.times is None
                or self.hits < self.spec.at + self.spec.times)
        if fire:
            self.fired += 1
        return fire


# The armed-spec stack.  Instrumented sites check truthiness before doing
# any work, so un-injected runs pay one list lookup per site.
_STACK: List[_Armed] = []


def active() -> bool:
    return bool(_STACK)


@contextlib.contextmanager
def inject(*specs: FaultSpec):
    """Arm the given specs for the dynamic extent of the block.  Yields the
    armed states (``.hits`` / ``.fired`` are readable for assertions).
    Nested ``inject`` blocks stack; counters reset on every entry."""
    armed = [_Armed(s) for s in specs]
    _STACK.extend(armed)
    try:
        yield armed
    finally:
        for a in armed:
            _STACK.remove(a)


def maybe_fire(site: str, **info) -> None:
    """Instrumentation hook: raise the armed fault matching this arrival.

    Poison specs never raise here — they are applied to results via
    :func:`poison_matches`.  Arrival counting happens for every matching
    armed spec (so two specs at the same site count independently).
    """
    if not _STACK:
        return
    for armed in list(_STACK):
        if armed.spec.kind == "poison" or not armed.matches(site, info):
            continue
        if armed.arrive():
            raise _ERRORS[armed.spec.kind](
                f"{_MESSAGES[armed.spec.kind]} [site={site}"
                + (f", mode={info['mode']}" if "mode" in info else "")
                + f", arrival={armed.hits}]")


def poison_matches(site: str, **info) -> List[FaultSpec]:
    """The poison specs firing at this arrival (counted like any other)."""
    if not _STACK:
        return []
    out = []
    for armed in list(_STACK):
        if armed.spec.kind != "poison" or not armed.matches(site, info):
            continue
        if armed.arrive():
            out.append(armed.spec)
    return out
