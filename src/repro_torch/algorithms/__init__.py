"""Algorithms on ds-arrays (paper §5): K-means, ALS, PCA and TSQR, with the
Dataset baseline's K-means and ALS.  Every class implements the
``repro_torch.estimators`` contract."""

from repro_torch.algorithms.kmeans import KMeans, kmeans_dataset
from repro_torch.algorithms.als import ALS, als_dataset
from repro_torch.algorithms.linalg import PCA, frobenius, pca, tsqr

__all__ = ["KMeans", "kmeans_dataset", "ALS", "als_dataset",
           "PCA", "pca", "tsqr", "frobenius"]
