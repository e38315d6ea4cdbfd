"""Algorithms on ds-arrays: K-means (paper §5.5)."""

from repro_torch.algorithms.kmeans import KMeans

__all__ = ["KMeans"]
