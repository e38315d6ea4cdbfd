"""The dislib-style estimator layer of the port: the contract (``base``) and
the three estimators the paper's evaluation names — CascadeSVM, the linear
models (normal equations + TSQR fallback) and a random forest (histogram
trees on the stacked blocks).  ``repro_torch.algorithms``'s KMeans / ALS /
PCA implement the same :class:`BaseEstimator` contract (import them from
there: algorithms import estimators, never the reverse)."""

from repro_torch.estimators.base import (BaseClassifier, BaseEstimator,
                                         BaseRegressor, NotFittedError,
                                         resolve_estimator)
from repro_torch.estimators.csvm import CascadeSVM
from repro_torch.estimators.forest import RandomForestClassifier
from repro_torch.estimators.linear import LinearRegression, Ridge

__all__ = [
    "BaseEstimator", "BaseClassifier", "BaseRegressor", "NotFittedError",
    "CascadeSVM", "LinearRegression", "Ridge", "RandomForestClassifier",
    "resolve_estimator",
]
