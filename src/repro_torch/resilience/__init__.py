"""Resilience for the port: fault injection, guarded execution, numerical
guards (the port of ``repro.resilience``).

* :mod:`repro_torch.resilience.inject` — deterministic, seeded,
  context-scoped fault injection (``with inject(FaultSpec(...)):``), so
  every recovery path can be proven;
* :mod:`repro_torch.resilience.execute` — :func:`run_resilient`: error
  classification, bounded retry with backoff for transients, and the OOM
  ladder fused -> eager -> einsum (the GEMM kernel with a small split-K
  workspace);
* :mod:`repro_torch.resilience.guards` — block-granular numerical guards
  (``DsArray.finite_report()``, ``guard_finite``,
  :class:`NumericalDivergence`).

``inject`` imports nothing of the package, so ``core.plan``,
``kernels.matmul.ops``, ``checkpoint``, ``core.io`` and the estimators reach
it through ``repro_torch._faults.fire``, which looks it up by module name
(``sys.modules``) without importing it.
"""

from repro_torch.resilience.execute import (
    DETERMINISTIC,
    OOM,
    TRANSIENT,
    RetryPolicy,
    classify_error,
    reset_stats,
    run_resilient,
    stats,
)
from repro_torch.resilience.guards import (
    BadBlock,
    FiniteReport,
    NumericalDivergence,
    all_finite,
    finite_report,
    guard_finite,
    poison_block,
    require_finite_host,
)
from repro_torch.resilience.inject import (
    CrashError,
    FaultError,
    FaultSpec,
    IOLoadError,
    OOMError,
    TransientError,
    inject,
    maybe_fire,
    poison_matches,
)

__all__ = [
    "BadBlock",
    "CrashError",
    "DETERMINISTIC",
    "FaultError",
    "FaultSpec",
    "FiniteReport",
    "IOLoadError",
    "NumericalDivergence",
    "OOM",
    "OOMError",
    "RetryPolicy",
    "TRANSIENT",
    "TransientError",
    "all_finite",
    "classify_error",
    "finite_report",
    "guard_finite",
    "inject",
    "maybe_fire",
    "poison_block",
    "poison_matches",
    "require_finite_host",
    "reset_stats",
    "run_resilient",
    "stats",
]
