"""The dislib-style estimator layer of the port: the contract (``base``) and
the three estimators the paper's evaluation names — CascadeSVM, the linear
models (normal equations + TSQR fallback) and a random forest (histogram
trees on the stacked blocks).  ``repro_torch.algorithms``'s KMeans / ALS /
PCA implement the same :class:`BaseEstimator` contract (import them from
there: algorithms import estimators, never the reverse).

Model registry: ``save_model``/``load_model`` persist fitted estimators
through ``repro_torch.checkpoint`` in the reference's ``repro-model-v1``
format; :func:`load_model` here dispatches on the class name the manifest
records (``repro_torch.algorithms`` names resolve at call time)."""

from repro_torch.estimators.base import (BaseClassifier, BaseEstimator,
                                         BaseRegressor, NotFittedError,
                                         resolve_estimator)
from repro_torch.estimators.csvm import CascadeSVM
from repro_torch.estimators.forest import RandomForestClassifier
from repro_torch.estimators.linear import LinearRegression, Ridge


def load_model(directory: str, version=None, device="cuda") -> BaseEstimator:
    """Reconstruct any saved model (of either package) with its fitted
    arrays on ``device``: the manifest names the class, the registry
    (estimators exports, then ``repro_torch.algorithms``) resolves it.
    ``version`` pins a checkpoint step (default: the newest committed)."""
    return BaseEstimator.load_model(directory, version=version, device=device)


__all__ = [
    "BaseEstimator", "BaseClassifier", "BaseRegressor", "NotFittedError",
    "CascadeSVM", "LinearRegression", "Ridge", "RandomForestClassifier",
    "load_model", "resolve_estimator",
]
