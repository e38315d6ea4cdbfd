"""Estimator contract for the dislib-style fit/predict layer (the port of
``repro.estimators.base``).

* ``fit(x[, y]) -> self`` with ``x`` a ds-array (dense or sparse blocks,
  any block grid) and ``y`` a ds-array, tensor or array of targets;
* ``predict(x) -> DsArray`` returning a NEW ``(n, 1)`` distributed array;
* ``score(x, y) -> float`` (accuracy for classifiers, R² for regressors,
  model-specific otherwise);
* ``get_params() / set_params(**p)`` over the constructor parameters —
  estimators are dataclasses, and fields whose name ends in ``_`` are
  FITTED state, everything else is a parameter.

Fit loops record their hot products through the lazy layer
(``DsArray.lazy()``): each iteration re-records a structurally identical
plan, so iterations 2..N skip the optimizer and reuse the cached run
(``core.plan``).  Fitted state lives on the device of the fitted input.

Not ported yet: ``save_model``/``load_model`` and the per-iteration fit
checkpoints (``checkpoint_dir``/``resume`` raise ``NotImplementedError``),
and the fault-injection hook of the fit loops.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import plan as _plan
from repro_torch.core.dsarray import DsArray, from_array


class NotFittedError(RuntimeError):
    pass


def _iter_span(est, iteration: int):
    """One ``fit.iteration`` trace span per outer fit-loop pass (the no-op
    singleton when tracing is off)."""
    from repro_torch.obs import tracing as _tracing
    return _tracing.span("fit.iteration", estimator=type(est).__name__,
                         iteration=iteration)


def _no_checkpoints(est, checkpoint_dir, resume) -> None:
    """Fit checkpoints are not ported yet: asking for one raises rather than
    fitting without it."""
    if checkpoint_dir is not None or resume is not None:
        raise NotImplementedError(
            f"{type(est).__name__}.fit: checkpoint_dir/resume need the fit "
            f"checkpoints, which are not ported yet (ROADMAP.md §1 item 5)")


def _host(v) -> np.ndarray:
    """A DsArray, tensor or array-like as a host NumPy array."""
    if isinstance(v, DsArray):
        v = v.collect()
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def resolve_estimator(name: str) -> type:
    """Estimator class by name — ``repro_torch.estimators`` exports first,
    then ``repro_torch.algorithms`` (imported here, at call time, so the
    import graph stays acyclic)."""
    import importlib
    import repro_torch.estimators as _pkg
    klass = getattr(_pkg, name, None)
    if klass is None:
        alg = importlib.import_module("repro_torch.algorithms")
        klass = getattr(alg, name, None)
    if not (isinstance(klass, type) and issubclass(klass, BaseEstimator)):
        raise KeyError(f"unknown estimator {name!r}")
    return klass


@dataclasses.dataclass
class BaseEstimator:
    """get_params/set_params + input validation over dataclass fields.

    Subclasses are ``@dataclasses.dataclass``; parameter fields precede
    fitted fields (named with a trailing underscore and defaulted) so the
    generated ``__init__`` keeps the sklearn constructor shape.
    """

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

    @staticmethod
    def _driver_scope():
        """Mask ambient ``repro_torch.lazy()`` recording around estimator
        driver code.  Hot loops record through EXPLICIT ``.lazy()`` lifts
        (which record regardless of the ambient flag), so validation,
        chunking and the small solves stay eager even when a caller wraps
        ``fit`` in the context manager."""
        from repro_torch.core import expr
        return expr.suspend_lazy()

    def _check_fitted(self, attr: str) -> None:
        if getattr(self, attr, None) is None:
            raise NotFittedError(
                f"{type(self).__name__}: call fit before predict/score")

    # -- predict-plan capture ------------------------------------------------
    def _predict_expr(self, xl):
        """Record this estimator's predict on the lazy-lifted input ``xl``
        and return the recorded lazy result.  Estimators whose predict
        lowers through the lazy layer implement this (linear models do);
        ``predict`` and :meth:`predict_plan` both route through it."""
        raise NotImplementedError(
            f"{type(self).__name__} has no recordable predict plan")

    def has_predict_plan(self) -> bool:
        """True when :meth:`_predict_expr` is overridden."""
        return type(self)._predict_expr is not BaseEstimator._predict_expr

    def predict_plan(self, x) -> "_plan.Plan":
        """``predict(x)`` captured as ONE optimized plan, not executed."""
        with self._driver_scope():
            x = self._validate_x(x)
            lz = self._predict_expr(x.lazy())
        return _plan.plan_for(lz)

    # -- input validation ----------------------------------------------------
    @staticmethod
    def _validate_x(x, default_block_rows: int = 128,
                    device="cuda") -> DsArray:
        """``x`` as a 2-D ds-array: a DsArray (dense or sparse) passes
        through untouched — validation never densifies a sparse input — and
        a raw 2-D array is blocked with a default grid on ``device``."""
        if isinstance(x, DsArray):
            return x
        arr = _host(x)
        if arr.ndim != 2:
            raise ValueError(f"estimator inputs are 2-D, got shape {arr.shape}")
        bn = min(default_block_rows, max(1, arr.shape[0]))
        return from_array(arr, (bn, max(1, arr.shape[1])), device=device)

    @staticmethod
    def _validate_y(y, n_rows: int) -> np.ndarray:
        """Targets as a 1-D host vector of length ``n_rows``.  Accepts an
        ``(n, 1)``/``(1, n)`` ds-array, a tensor or any array-like; targets
        are O(n) and consumed by host-side drivers."""
        if isinstance(y, DsArray) and 1 not in y.shape:
            raise ValueError(f"y must be a vector, got shape {y.shape}")
        y = _host(y).ravel()
        if y.shape[0] != n_rows:
            raise ValueError(
                f"x has {n_rows} rows but y has {y.shape[0]} entries")
        return y

    def _validate_fit(self, x, y) -> Tuple[DsArray, np.ndarray]:
        x = self._validate_x(x)
        return x, self._validate_y(y, x.shape[0])

    @staticmethod
    def _labels_ds(values, like: DsArray) -> DsArray:
        """A 1-D result vector as the conventional ``(n, 1)`` ds-array,
        blocked like ``like``'s rows, on ``like``'s device."""
        if not isinstance(values, torch.Tensor):
            values = torch.as_tensor(np.asarray(values))
        return from_array(values.reshape(-1, 1), (like.block_shape[0], 1),
                          device=like.device)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"{type(self).__name__}({params})"


@dataclasses.dataclass
class BaseClassifier(BaseEstimator):
    """Classifier mixin: label encoding + accuracy score."""

    def _encode_labels(self, y: np.ndarray,
                       n_classes: Optional[int] = None) -> np.ndarray:
        """Store ``classes_`` and return integer-encoded labels."""
        classes, encoded = np.unique(y, return_inverse=True)
        if not np.issubdtype(classes.dtype, np.number):
            # predictions travel back as (n, 1) ds-arrays, which are
            # numeric tensors: reject string labels up front
            raise ValueError(
                f"{type(self).__name__} needs numeric labels, got dtype "
                f"{classes.dtype}; encode them first")
        if n_classes is not None and len(classes) != n_classes:
            raise ValueError(
                f"{type(self).__name__} needs exactly {n_classes} classes, "
                f"got {len(classes)}: {classes}")
        self.classes_ = classes
        return encoded

    def score(self, x, y) -> float:
        """Mean accuracy of ``predict(x)`` against ``y``."""
        x = self._validate_x(x)
        y = self._validate_y(y, x.shape[0])
        pred = _host(self.predict(x)).ravel()
        return float((pred == y).mean())


@dataclasses.dataclass
class BaseRegressor(BaseEstimator):
    """Regressor mixin: R² score."""

    def score(self, x, y) -> float:
        """Coefficient of determination R² of ``predict(x)`` vs ``y``."""
        x = self._validate_x(x)
        y = self._validate_y(y, x.shape[0]).astype(np.float64)
        pred = _host(self.predict(x)).ravel().astype(np.float64)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else \
            (1.0 if ss_res == 0 else 0.0)
