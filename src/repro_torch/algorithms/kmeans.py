"""K-means on ds-arrays (paper §5.5), the port of ``repro.algorithms.kmeans``.

The Lloyd assignment step (distances -> argmin -> per-cluster sums and
counts) is one launch of the fused CUDA kernel ``kmeans_assign`` on the
stacked block tensor, the counterpart of the paper's per-Subset task.  The
reference's jitted ``while_loop`` is a host loop here with the same
``tol``/``max_iter`` rule: one sync per iteration to test the shift.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dsarray import DsArray, from_array
from repro_torch.estimators.base import BaseEstimator, _iter_span
from repro_torch.kernels.kmeans.ops import kmeans_assign_stacked
from repro_torch.obs import tracing as _tracing


def _row_sq_norms(x: DsArray) -> torch.Tensor:
    """Per-row squared norms ``(gn, bn)``: ``(x*x).sum(axis=1)``, eagerly."""
    s = (x * x).sum(axis=1)                          # (n, 1) ds-array
    gn, bn = x.blocks.shape[0], x.blocks.shape[2]
    return s.blocks.reshape(gn, bn).to(torch.float32)


def _center_stats(blocks: torch.Tensor, n: int, centers: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distance + assign + partial sums over the stacked block tensor.

    blocks:  (gn, gm, bn, bm) feature-blocked samples (pad = 0)
    n:       valid rows
    centers: (k, gm*bm), pad columns zero
    returns (labels (gn, bn) with -1 on rows >= n, sums (k, gm*bm),
    counts (k,))
    """
    gn, gm, bn, bm = blocks.shape
    labels, sums, counts = kmeans_assign_stacked(
        blocks.to(torch.float32).contiguous(),
        centers.to(torch.float32).contiguous(), n)
    return labels.reshape(gn, bn), sums, counts


def _d2_to_center(blocks: torch.Tensor, row_valid: torch.Tensor,
                  center: torch.Tensor) -> torch.Tensor:
    """Per-row squared distance to one center over the stacked tensor, in the
    squared-difference form; ``center`` is the (gm*bm,)-padded row, so pad
    columns contribute nothing.  Returns (gn, bn) with invalid rows zeroed."""
    gn, gm, bn, bm = blocks.shape
    diff = blocks - center.reshape(gm, bm)[None, :, None, :]
    d2 = torch.einsum("ijab,ijab->ia", diff, diff)
    return d2 * row_valid.to(d2.dtype)


def _kmeanspp_init_ds(x: DsArray, k: int, rng: np.random.Generator,
                      row_valid: torch.Tensor) -> torch.Tensor:
    """Block-native k-means++ (D² sampling) with the reference's NumPy draws,
    so both packages pick the same rows; only the O(n) distance vector and
    the chosen rows reach the host."""
    n, m = x.shape
    gn, gm, bn, bm = x.blocks.shape

    def fetch_row(i: int) -> torch.Tensor:
        row = x[int(i)].collect().reshape(-1)        # (m,)
        return torch.nn.functional.pad(row, (0, gm * bm - m))

    centers = [fetch_row(int(rng.integers(n)))]
    d2 = _d2_to_center(x.blocks, row_valid, centers[0])
    for _ in range(1, k):
        d = np.maximum(d2.double().cpu().numpy().reshape(-1)[:n], 0.0)
        tot = d.sum()
        # degenerate data (all rows coincide with a center): uniform fallback
        p = d / tot if tot > 0 else np.full(n, 1.0 / n)
        centers.append(fetch_row(int(rng.choice(n, p=p))))
        d2 = torch.minimum(d2, _d2_to_center(x.blocks, row_valid, centers[-1]))
    return torch.stack(centers)[:, : gm * bm]


@dataclasses.dataclass
class KMeans(BaseEstimator):
    """dislib-style estimator: ``KMeans(...).fit(x)`` with x a ds-array.
    ``score`` is the clustering convention (negative inertia)."""

    n_clusters: int = 8
    max_iter: int = 20
    tol: float = 1e-4
    seed: int = 0

    centers_: Optional[torch.Tensor] = None
    n_iter_: int = 0

    @staticmethod
    def _row_valid(x: DsArray) -> torch.Tensor:
        gn, gm, bn, bm = x.blocks.shape
        rows = torch.arange(gn * bn, device=x.device).reshape(gn, bn)
        return rows < x.shape[0]

    def fit(self, x: DsArray, y=None) -> "KMeans":
        del y                     # unsupervised; kept for the fit(x, y) shape
        x = self._validate_x(x).ensure_zero_pad()  # contractions read raw blocks
        n, m = x.shape
        centers = _kmeanspp_init_ds(x, self.n_clusters,
                                    np.random.default_rng(self.seed),
                                    self._row_valid(x))
        it = 0
        shift = float("inf")
        with _tracing.span("fit.loop", estimator=type(self).__name__,
                           max_iter=self.max_iter):
            while shift > self.tol and it < self.max_iter:
                it += 1
                with _iter_span(self, it):
                    _, sums, counts = _center_stats(x.blocks, n, centers)
                    safe = torch.clamp(counts, min=1.0)[:, None]
                    new = torch.where(counts[:, None] > 0, sums / safe, centers)
                    shift = float(torch.sqrt(((new - centers) ** 2).sum()))
                    centers = new
        self.centers_ = centers[:, :m]
        self.n_iter_ = it
        return self

    def _padded_centers(self, x: DsArray) -> torch.Tensor:
        gn, gm, bn, bm = x.blocks.shape
        c = self.centers_.to(x.device)
        return torch.nn.functional.pad(c, (0, gm * bm - c.shape[1]))

    def predict(self, x: DsArray) -> DsArray:
        """Labels as a new (n, 1) ds-array (predict never mutates its input)."""
        self._check_fitted("centers_")
        x = self._validate_x(x).ensure_zero_pad()
        labels, _, _ = _center_stats(x.blocks, x.shape[0],
                                     self._padded_centers(x))
        flat = labels.reshape(-1, 1)[: x.shape[0]]
        return from_array(flat, (x.block_shape[0], 1), device=x.device)

    def score(self, x: DsArray, y=None) -> float:
        """Negative inertia (sum of squared distances to the nearest center)."""
        del y
        self._check_fitted("centers_")
        x = self._validate_x(x).ensure_zero_pad()
        gn, gm, bn, bm = x.blocks.shape
        centers = self._padded_centers(x)
        blocks = x.blocks.to(torch.float32)
        dots = torch.einsum("ijab,kjb->iak", blocks,
                            centers.reshape(-1, gm, bm))
        c_sq = (centers * centers).sum(dim=1)
        dist = _row_sq_norms(x)[..., None] - 2 * dots + c_sq[None, None, :]
        best = dist.min(dim=-1).values * self._row_valid(x)
        return float(-best.sum())
