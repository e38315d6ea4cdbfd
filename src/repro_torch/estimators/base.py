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

Persistence: ``save_model``/``load_model`` and the per-iteration fit
checkpoints (``_FitCheckpoint``, behind the fits' ``checkpoint_dir``/
``resume``) write the reference's ``repro-model-v1`` format through
``repro_torch.checkpoint``, so a model either package saves loads in the
other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._faults import fire as _fire
from repro_torch import checkpoint as _ckpt
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


def _host(v) -> np.ndarray:
    """A DsArray, tensor or array-like as a host NumPy array."""
    if isinstance(v, DsArray):
        v = v.collect()
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


# ---------------------------------------------------------------------------
# Fitted-state (de)serialization over the trailing-underscore convention
# ---------------------------------------------------------------------------
#
# A fitted estimator's state is exactly its ``name_`` attributes.  Packing
# splits that dict into arrays (checkpoint leaves) and JSON-able metadata
# (the manifest's ``extra``): scalars inline, DsArray fields as collected
# arrays + blocking so load rebuilds the distributed layout.  The same pair
# backs ``save_model``/``load_model`` and the per-iteration fit checkpoints
# (``_FitCheckpoint``): one wire format, the reference's.

MODEL_FORMAT = "repro-model-v1"


def _pack_state(state: Dict[str, Any]) -> Tuple[Dict[str, Any], dict]:
    """(arrays, meta).  Tensors stay tensors here: ``checkpoint.save``
    copies them to the host, 64-bit ones narrowed to 32 bits as the
    reference's device arrays are; NumPy arrays are written as they are."""
    arrays: Dict[str, Any] = {}
    meta: dict = {"scalars": {}, "arrays": [], "ds": {}}
    for k, v in state.items():
        if isinstance(v, np.generic):
            v = v.item()
        if isinstance(v, DsArray):
            meta["ds"][k] = {"block_shape": list(v.block_shape),
                             "sparse": bool(v.is_sparse)}
            arrays[k] = v.collect()
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            meta["arrays"].append(k)
            arrays[k] = v
        elif isinstance(v, (bool, int, float, str)) or v is None:
            meta["scalars"][k] = v
        else:
            raise TypeError(
                f"cannot serialize fitted field {k!r} of type "
                f"{type(v).__name__}; supported: scalars, arrays, DsArray")
    return arrays, meta


def _unpack_state(arrays: Dict[str, torch.Tensor], meta: dict,
                  device="cuda") -> Dict[str, Any]:
    """The fitted state back: array fields as tensors on ``device`` (32-bit,
    as the reference's ``jnp.asarray`` gives them), DsArray fields blocked
    as they were saved."""
    out: Dict[str, Any] = dict(meta["scalars"])
    for k in meta["arrays"]:
        out[k] = arrays[k].to(device)
    for k, info in meta["ds"].items():
        a = from_array(arrays[k], tuple(info["block_shape"]), device=device)
        if info["sparse"]:
            a = a.tosparse()
        out[k] = a
    return out


def _manifest_protos(root: str, step: int) -> Dict[str, torch.Tensor]:
    """``meta`` tensors of each leaf's recorded shape and dtype: restore
    protos that cost no memory."""
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    like = {}
    for e in man["leaves"]:
        dt = torch.bfloat16 if e["dtype"] == "bfloat16" else \
            torch.from_numpy(np.zeros(0, np.dtype(e["dtype"]))).dtype
        like[e["path"]] = torch.empty(tuple(e["shape"]), dtype=dt,
                                      device="meta")
    return like


def _load_arrays(root: str, step: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Restore a flat name->array checkpoint WITHOUT caller-side protos:
    the ``like`` tree is rebuilt from the manifest's recorded shapes and
    dtypes (so no ``allow_cast`` is needed)."""
    return _ckpt.restore(root, step, _manifest_protos(root, step),
                         device=device)


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


class _FitCheckpoint:
    """Per-outer-iteration fit state in the ``checkpoint`` layout.

    ``save(it, state)`` commits atomically (step == iteration), so a crash
    mid-write leaves the previous committed iteration as the newest;
    ``load(device=...)`` returns ``(iteration, state)`` for the newest
    committed state, or None when the directory holds none (a fresh start).
    The estimator name is recorded and checked, so resuming a CSVM fit from
    an ALS directory fails loudly.
    """

    def __init__(self, directory: str, estimator: str):
        self.directory = directory
        self.estimator = estimator

    def save(self, iteration: int, state: Dict[str, Any]) -> None:
        arrays, meta = _pack_state(state)
        _ckpt.save(self.directory, iteration, arrays,
                   extra={"format": MODEL_FORMAT, "estimator": self.estimator,
                          "iteration": iteration, "state": meta})

    def load(self, iteration: Optional[int] = None, device="cuda"):
        it = iteration if iteration is not None \
            else _ckpt.latest_step(self.directory)
        if it is None:
            return None
        extra = _ckpt.manifest_extra(self.directory, it)
        if extra.get("estimator") != self.estimator:
            raise ValueError(
                f"resume directory {self.directory!r} holds "
                f"{extra.get('estimator')!r} state, not {self.estimator!r}")
        return it, _unpack_state(_load_arrays(self.directory, it, device),
                                 extra["state"], device)


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

    # -- model (de)serialization ---------------------------------------------
    def _fitted_state(self) -> Dict[str, Any]:
        """The trailing-underscore attributes (declared fields AND ones set
        during fit, e.g. ``classes_`` from ``_encode_labels``)."""
        return {k: v for k, v in vars(self).items()
                if k.endswith("_") and not k.startswith("_")}

    def _is_fitted(self, fitted: Optional[Dict[str, Any]] = None) -> bool:
        """Fitted means some trailing-underscore attribute moved off its
        declared dataclass default (unfitted estimators still carry
        non-None scalar defaults like ``intercept_ = 0.0``)."""
        if fitted is None:
            fitted = self._fitted_state()
        defaults = {f.name: f.default for f in dataclasses.fields(self)
                    if f.default is not dataclasses.MISSING}
        for k, v in fitted.items():
            if v is None:
                continue
            if isinstance(v, (bool, int, float, str)) and k in defaults \
                    and v == defaults[k]:
                continue
            return True
        return False

    def save_model(self, directory: str, version: int = 0) -> str:
        """Persist params + fitted state through ``repro_torch.checkpoint``
        (atomic commit) in the reference's ``repro-model-v1`` format.  The
        manifest records the estimator class, so ``estimators.load_model``
        reconstructs the model without knowing its type; ``version`` is the
        checkpoint step, so one directory holds a version history."""
        fitted = self._fitted_state()
        if not self._is_fitted(fitted):
            raise NotFittedError(
                f"{type(self).__name__}: nothing fitted to save")
        arrays, meta = _pack_state(fitted)
        return _ckpt.save(
            directory, version, arrays,
            extra={"format": MODEL_FORMAT,
                   "estimator": type(self).__name__,
                   "version": version,
                   "params": self.get_params(), "state": meta})

    @classmethod
    def load_model(cls, directory: str, version: Optional[int] = None,
                   device="cuda") -> "BaseEstimator":
        """Reconstruct a fitted estimator saved by ``save_model`` (of either
        package), its fitted arrays on ``device``.  Call on the concrete
        class (checked against the manifest) or on ``BaseEstimator`` / via
        ``estimators.load_model`` to dispatch on the recorded class name.
        ``version=None`` loads the newest committed version."""
        step = version if version is not None \
            else _ckpt.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no model checkpoint in {directory!r}")
        extra = _ckpt.manifest_extra(directory, step)
        name = extra.get("estimator")
        if cls is BaseEstimator:
            klass = resolve_estimator(name)
        else:
            if name != cls.__name__:
                raise ValueError(
                    f"{directory!r} holds a {name!r} model, not "
                    f"{cls.__name__}")
            klass = cls
        est = klass(**extra["params"])
        for k, v in _unpack_state(_load_arrays(directory, step, device),
                                  extra["state"], device).items():
            setattr(est, k, v)
        return est

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
