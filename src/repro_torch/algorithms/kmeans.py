"""K-means on ds-arrays (paper §5.5), the port of ``repro.algorithms.kmeans``,
and the Dataset baseline's K-means (``kmeans_dataset``, host NumPy).

The Lloyd assignment step (distances -> argmin -> per-cluster sums and
counts) is one launch of the fused CUDA kernel ``kmeans_assign`` on the
stacked block tensor, the counterpart of the paper's per-Subset task.  A
sparse x takes the reference's sparse form instead: ``x·cᵀ`` and
``onehotᵀ·x`` contract the stored entries (``local_matmul``'s sparse
dispatch) and the argmin runs in torch, so x is never densified.  The
reference's jitted ``while_loop`` is a host loop here with the same
``tol``/``max_iter`` rule: one sync per iteration to test the shift.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dataset_baseline import Dataset
from repro_torch.core.dsarray import DsArray, from_array
from repro_torch.estimators.base import BaseEstimator, _iter_span
from repro_torch.kernels.kmeans.ops import kmeans_assign_stacked
from repro_torch.kernels.matmul.ops import local_matmul
from repro_torch.obs import tracing as _tracing


def _row_sq_norms(x: DsArray) -> torch.Tensor:
    """Per-row squared norms ``(gn, bn)`` through one lazy plan: the square
    fused into the row sum, no remask on the ZERO pad, and the plan cached
    by structure, so every later call skips the optimizer."""
    s = (x.lazy() * x).sum(axis=1).compute()        # (n, 1) ds-array
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


def _dots(x: DsArray, centers: torch.Tensor) -> torch.Tensor:
    """``x · cᵀ`` summed over feature blocks, ``(gn, bn, k)`` f32, for the
    (k, gm*bm)-padded ``centers``: an einsum over the dense stacked tensor,
    the stored entries through ``local_matmul`` for a sparse x."""
    gn, gm, bn, bm = x.blocks.shape
    c_blocks = centers.reshape(-1, gm, bm)
    if x.is_sparse:
        rhs = c_blocks.permute(1, 2, 0)[:, None]          # (gm, 1, bm, k)
        return local_matmul(x.blocks, rhs, out_dtype=torch.float32)[:, 0]
    return torch.einsum("ijab,kjb->iak", x.blocks.to(torch.float32), c_blocks)


def _sparse_center_stats(x: DsArray, row_valid: torch.Tensor,
                         centers: torch.Tensor, x_sq: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The assignment step of a sparse x, as the reference's sparse branch:
    ``‖x‖² − 2x·cᵀ + ‖c‖²``, the first minimum, then ``onehotᵀ·x`` with
    the sparse side on the (transposed) left.  ``x_sq`` is ``(gn, bn)``
    (:func:`_row_sq_norms`).  Returns (labels (gn, bn), sums (k, gm*bm),
    counts (k,))."""
    gn, gm, bn, bm = x.blocks.shape
    k = centers.shape[0]
    c_sq = (centers * centers).sum(dim=1)
    # x_sq - 2·dots + c_sq, in place over the (gn, bn, k) products (the
    # same bits: -2·dots is exact and the sum commutes)
    dist = _dots(x, centers).mul_(-2.0).add_(x_sq[..., None]).add_(c_sq)
    labels = torch.argmin(dist, dim=-1)
    del dist
    onehot = torch.zeros((gn, bn, k), dtype=torch.float32, device=labels.device)
    onehot.scatter_(2, labels[..., None], row_valid[..., None].to(torch.float32))
    sums = local_matmul(x.blocks, onehot[:, None], out_dtype=torch.float32,
                        transpose_a=True)                   # (gm, 1, bm, k)
    sums = sums[:, 0].permute(2, 0, 1).reshape(k, gm * bm)
    return labels, sums, onehot.sum(dim=(0, 1))


def _d2_to_center(x: DsArray, row_valid: torch.Tensor, center: torch.Tensor,
                  x_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row squared distance to one center over the stacked tensor;
    ``center`` is the (gm*bm,)-padded row, so pad columns contribute
    nothing.  Dense blocks take the squared-difference form; a sparse x the
    ``‖x‖² − 2x·c + ‖c‖²`` form (``x_sq`` from :func:`_row_sq_norms`), so
    only stored entries are read.  Returns (gn, bn), invalid rows zeroed."""
    gn, gm, bn, bm = x.blocks.shape
    if x.is_sparse:
        dots = _dots(x, center[None])[..., 0]
        d2 = torch.clamp(x_sq - 2.0 * dots + torch.sum(center * center), min=0.0)
    else:
        diff = x.blocks - center.reshape(gm, bm)[None, :, None, :]
        d2 = torch.einsum("ijab,ijab->ia", diff, diff)
    return d2 * row_valid.to(d2.dtype)


def _kmeanspp_init_ds(x: DsArray, k: int, rng: np.random.Generator,
                      row_valid: torch.Tensor,
                      x_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-native k-means++ (D² sampling) with the reference's NumPy draws,
    so both packages pick the same rows; only the O(n) distance vector and
    the chosen rows reach the host.  A sparse x needs ``x_sq``."""
    n, m = x.shape
    gn, gm, bn, bm = x.blocks.shape

    def fetch_row(i: int) -> torch.Tensor:
        if x.is_sparse:
            # one block row's stored entries, written into the padded row
            from repro_torch.core import sparse as sparse_mod
            return sparse_mod.fetch_row_dense(x, int(i))
        row = x[int(i)].collect().reshape(-1)        # (m,)
        return torch.nn.functional.pad(row, (0, gm * bm - m))

    centers = [fetch_row(int(rng.integers(n)))]
    d2 = _d2_to_center(x, row_valid, centers[0], x_sq)
    for _ in range(1, k):
        d = np.maximum(d2.double().cpu().numpy().reshape(-1)[:n], 0.0)
        tot = d.sum()
        # degenerate data (all rows coincide with a center): uniform fallback
        p = d / tot if tot > 0 else np.full(n, 1.0 / n)
        centers.append(fetch_row(int(rng.choice(n, p=p))))
        d2 = torch.minimum(d2, _d2_to_center(x, row_valid, centers[-1], x_sq))
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
        with self._driver_scope():
            return self._fit(x)

    def _fit(self, x: DsArray) -> "KMeans":
        x = self._validate_x(x).ensure_zero_pad()  # contractions read raw blocks
        n, m = x.shape
        row_valid = self._row_valid(x)
        # a sparse x's ‖x‖², hoisted out of the init and the Lloyd loop (the
        # dense kernel forms its own)
        x_sq = _row_sq_norms(x) if x.is_sparse else None
        centers = _kmeanspp_init_ds(x, self.n_clusters,
                                    np.random.default_rng(self.seed),
                                    row_valid, x_sq)
        it = 0
        shift = float("inf")
        with _tracing.span("fit.loop", estimator=type(self).__name__,
                           max_iter=self.max_iter):
            while shift > self.tol and it < self.max_iter:
                it += 1
                with _iter_span(self, it):
                    if x.is_sparse:
                        _, sums, counts = _sparse_center_stats(
                            x, row_valid, centers, x_sq)
                    else:
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
        with self._driver_scope():
            return self._predict(x)

    def _predict(self, x: DsArray) -> DsArray:
        x = self._validate_x(x).ensure_zero_pad()
        if x.is_sparse:
            labels, _, _ = _sparse_center_stats(
                x, self._row_valid(x), self._padded_centers(x), _row_sq_norms(x))
            labels = labels.to(torch.int32)
        else:
            labels, _, _ = _center_stats(x.blocks, x.shape[0],
                                         self._padded_centers(x))
        flat = labels.reshape(-1, 1)[: x.shape[0]]
        return from_array(flat, (x.block_shape[0], 1), device=x.device)

    def score(self, x: DsArray, y=None) -> float:
        """Negative inertia (sum of squared distances to the nearest center)."""
        del y
        self._check_fitted("centers_")
        with self._driver_scope():
            return self._score(x)

    def _score(self, x: DsArray) -> float:
        x = self._validate_x(x).ensure_zero_pad()
        centers = self._padded_centers(x)
        dots = _dots(x, centers)
        c_sq = (centers * centers).sum(dim=1)
        dist = _row_sq_norms(x)[..., None] - 2 * dots + c_sq[None, None, :]
        best = dist.min(dim=-1).values * self._row_valid(x)
        return float(-best.sum())


# ---------------------------------------------------------------------------
# Dataset-baseline K-means (paper Fig. 9 parity experiment): host NumPy, as
# the reference's
# ---------------------------------------------------------------------------


def _kmeanspp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding (Arthur & Vassilvitskii) — D² sampling."""
    n = x.shape[0]
    centers = [x[rng.integers(n)]]
    d2 = ((x - centers[0]) ** 2).sum(-1)
    for _ in range(1, k):
        tot = d2.sum()
        # degenerate data (every remaining point coincides with a center):
        # D² sampling is undefined, fall back to uniform
        p = d2 / tot if tot > 0 else np.full(n, 1.0 / n)
        centers.append(x[rng.choice(n, p=p)])
        d2 = np.minimum(d2, ((x - centers[-1]) ** 2).sum(-1))
    return np.stack(centers).astype(x.dtype)


def kmeans_dataset(ds: Dataset, n_clusters: int, max_iter: int = 20,
                   tol: float = 1e-4, seed: int = 0) -> np.ndarray:
    """K-means with the Dataset task structure: one partial-sum task per
    Subset + a binary reduction tree per iteration (paper Fig. 3)."""
    rng = np.random.default_rng(seed)
    all_rows = ds.collect()
    centers = _kmeanspp_init(all_rows, n_clusters, rng)
    for _ in range(max_iter):
        def partial(x, centers=centers):
            d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
            lab = d.argmin(1)
            oh = np.eye(n_clusters, dtype=x.dtype)[lab]
            return np.concatenate([oh.T @ x, oh.sum(0)[:, None]], axis=1)

        partials = ds.map_subsets(partial)
        tot = ds.reduce(partials, np.add)
        sums, counts = tot[:, :-1], tot[:, -1]
        new = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1)[:, None],
                       centers)
        shift = float(np.sqrt(((new - centers) ** 2).sum()))
        centers = new
        if shift < tol:
            break
    return centers
