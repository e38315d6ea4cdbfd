"""Estimator contract for the dislib-style fit/predict layer (the subset of
``repro.estimators.base`` the port uses).

* ``fit(x[, y]) -> self`` with ``x`` a ds-array;
* ``predict(x) -> DsArray`` returning a NEW ``(n, 1)`` distributed array;
* ``score(x, y) -> float``;
* ``get_params() / set_params(**p)`` over the constructor parameters —
  estimators are dataclasses, and fields whose name ends in ``_`` are
  FITTED state, everything else is a parameter.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dsarray import DsArray, from_array


class NotFittedError(RuntimeError):
    pass


def _iter_span(est, iteration: int):
    """One ``fit.iteration`` trace span per outer fit-loop pass (the no-op
    singleton when tracing is off)."""
    from repro_torch.obs import tracing as _tracing
    return _tracing.span("fit.iteration", estimator=type(est).__name__,
                         iteration=iteration)


@dataclasses.dataclass
class BaseEstimator:
    """get_params/set_params + input validation over dataclass fields."""

    def get_params(self) -> dict:
        """Constructor parameters (dataclass fields without a trailing
        underscore), as a plain dict."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if not f.name.endswith("_")}

    def set_params(self, **params) -> "BaseEstimator":
        """Update parameters in place; unknown names raise."""
        valid = {f.name for f in dataclasses.fields(self)
                 if not f.name.endswith("_")}
        for name, value in params.items():
            if name not in valid:
                raise ValueError(
                    f"unknown parameter {name!r} for "
                    f"{type(self).__name__}; valid: {sorted(valid)}")
            setattr(self, name, value)
        return self

    def _check_fitted(self, attr: str) -> None:
        if getattr(self, attr, None) is None:
            raise NotFittedError(
                f"{type(self).__name__}: call fit before predict/score")

    @staticmethod
    def _validate_x(x, default_block_rows: int = 128,
                    device="cuda") -> DsArray:
        """``x`` as a 2-D ds-array: a DsArray (dense or sparse) passes
        through untouched — validation never densifies a sparse input — and
        a raw 2-D array is blocked with a default grid on ``device``."""
        if isinstance(x, DsArray):
            return x
        arr = np.asarray(x)
        if arr.ndim != 2:
            raise ValueError(f"estimator inputs are 2-D, got shape {arr.shape}")
        bn = min(default_block_rows, max(1, arr.shape[0]))
        return from_array(arr, (bn, max(1, arr.shape[1])), device=device)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"{type(self).__name__}({params})"
