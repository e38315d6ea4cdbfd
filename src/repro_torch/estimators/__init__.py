"""Estimator contract of the port (dislib-style fit/predict/score)."""

from repro_torch.estimators.base import BaseEstimator, NotFittedError

__all__ = ["BaseEstimator", "NotFittedError"]
