"""Numerical guards (the subset of ``repro.resilience.guards`` the port's
estimators use): :class:`NumericalDivergence` and
:func:`require_finite_host`, the guard for small host-side solver outputs.
The block-granular ``finite_report`` waits for the resilience layer."""

from __future__ import annotations

from typing import Optional

import numpy as np


class NumericalDivergence(ArithmeticError):
    """A guarded value contains NaN/Inf.  ``report`` holds the block report
    (None for host-array guards)."""

    def __init__(self, message: str, report: Optional[object] = None):
        super().__init__(message)
        self.report = report


def require_finite_host(arr: np.ndarray, what: str) -> np.ndarray:
    """Small host-side arrays (solver outputs): raise on NaN/Inf.  Callers
    that treat divergence as a fallback trigger catch
    :class:`NumericalDivergence` alongside ``LinAlgError``."""
    a = np.asarray(arr)
    if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
        n_nan = int(np.isnan(a).sum())
        n_inf = int(np.isinf(a).sum())
        raise NumericalDivergence(
            f"{what}: {n_nan} nan + {n_inf} inf in shape {a.shape}")
    return arr
