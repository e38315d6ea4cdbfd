"""Alternating Least Squares on ds-arrays (paper §5.3), the port of
``repro.algorithms.als``.

ALS alternates row- and column-access to the ratings matrix.  Datasets
(row-partitioned) must materialize a transposed COPY (N^2+N tasks + 2x
memory); ds-arrays block both axes, so the column pass is the transpose
view (a strided view of dense blocks; an O(nnz) index swap of sparse ones):

    U <- R  V (VᵀV + λI)⁻¹
    V <- Rᵀ U (UᵀU + λI)⁻¹

``f`` (latent factors) is small, so the Gram matrices and their inverses
are ``(f, f)`` tensors on the device; the big products ``R @ V`` and
``Rᵀ @ U`` are ds-array products (``stacked_matmul`` for dense R,
``sparse_contract`` for sparse R), and the ``(n, f) @ (f, f)`` products
run on ``stacked_matmul``.  The reference's jitted step is a plain function
here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dataset_baseline import Dataset
from repro_torch.core.dsarray import DsArray, from_array, random_array
from repro_torch.core.structural import gram
from repro_torch.estimators.base import (BaseEstimator, _FitCheckpoint,
                                         _fire, _iter_span)


def _solve_gram_ds(y: DsArray, reg: float) -> torch.Tensor:
    """(YᵀY + λI)⁻¹ with the Gram computed block-natively (no collect():
    ``core.structural.gram`` is one einsum over the stacked tensor)."""
    f = y.shape[1]
    g = gram(y) + reg * torch.eye(f, dtype=y.dtype, device=y.device)
    return torch.linalg.inv(g)


def _step(r: DsArray, rt: DsArray, u: DsArray, v: DsArray,
          reg: float) -> Tuple[DsArray, DsArray]:
    """One ALS iteration: both half-steps."""
    del u                                   # the U half-step reads V only
    f = v.block_shape[1]
    vg = _solve_gram_ds(v, reg)             # (f, f), on the device
    u_new = (r @ v) @ from_array(vg, (f, f), device=v.device)
    ug = _solve_gram_ds(u_new, reg)
    v_new = (rt @ u_new) @ from_array(ug, (f, f), device=v.device)
    return u_new, v_new


@dataclasses.dataclass
class ALS(BaseEstimator):
    """dislib-style estimator: ``ALS(...).fit(r)`` with r an (n x m)
    ds-array, dense or sparse.  ``predict(i, j)`` keeps the recommender
    signature (a single rating), and ``score(r)`` is the negative
    reconstruction RMSE over all n·m positions."""

    n_factors: int = 16
    reg: float = 0.1
    max_iter: int = 10
    tol: float = 1e-4
    seed: int = 0
    check_convergence: bool = True

    u_: Optional[DsArray] = None
    v_: Optional[DsArray] = None
    n_iter_: int = 0

    def fit(self, r: DsArray, y=None, checkpoint_dir: Optional[str] = None,
            resume: Optional[str] = None) -> "ALS":
        """Fit U and V.  ``checkpoint_dir`` commits ``{u, v, prev, done}``
        after every iteration; ``resume`` restarts from the newest committed
        iteration in that directory."""
        del y                     # the ratings matrix IS the target
        with self._driver_scope():
            return self._fit(r, checkpoint_dir, resume)

    def _fit(self, r: DsArray, checkpoint_dir: Optional[str],
             resume: Optional[str]) -> "ALS":
        r = self._validate_x(r)
        n, m = r.shape
        f = self.n_factors
        dev = r.device
        name = type(self).__name__
        # two generators on r's device, seeded from ``seed``
        su, sv = np.random.SeedSequence(self.seed).generate_state(2)
        gu = torch.Generator(device=dev).manual_seed(int(su))
        gv = torch.Generator(device=dev).manual_seed(int(sv))
        bn, bm = r.block_shape
        # factor matrices blocked along their long axis only
        u = random_array(gu, (n, f), (bn, f), device=dev) * 0.1
        v = random_array(gv, (m, f), (bm, f), device=dev) * 0.1
        rt = r.transpose()

        prev = float("inf")
        it = 0
        start_it = 1
        if resume is not None:
            got = _FitCheckpoint(resume, name).load(device=dev)
            if got is not None:
                it, st = got
                u, v, prev = st["u"], st["v"], float(st["prev"])
                if bool(st["done"]):
                    self.u_, self.v_, self.n_iter_ = u, v, it
                    return self
                start_it = it + 1
        ckpt = _FitCheckpoint(checkpoint_dir, name) \
            if checkpoint_dir is not None else None
        for it in range(start_it, self.max_iter + 1):
            _fire("fit_iteration", estimator=name, iteration=it)
            with _iter_span(self, it):
                u, v = self._step(r, rt, u, v)
                done = False
                if self.check_convergence:
                    err = self._rmse(r, u, v)
                    done = abs(prev - err) < self.tol
                    prev = err
                if ckpt is not None:
                    ckpt.save(it, {"u": u, "v": v, "prev": float(prev),
                                   "done": bool(done)})
                if done:
                    break
        self.u_, self.v_, self.n_iter_ = u, v, it
        return self

    def _step(self, r, rt, u, v):
        return _step(r, rt, u, v, self.reg)

    def _rmse(self, r: DsArray, u: DsArray, v: DsArray) -> float:
        """Over all n·m positions, through the dense ``u @ vᵀ`` (as the
        reference: at the Netflix Prize shape that is a 34 GB array)."""
        pred = u @ v.transpose()
        diff = pred - r
        return float(torch.sqrt((diff * diff).sum() / (r.shape[0] * r.shape[1])))

    def predict(self, i: int, j: int) -> float:
        """Predicted rating for (row i, col j)."""
        self._check_fitted("u_")
        with self._driver_scope():
            return float(
                (self.u_[i] @ self.v_[j].transpose()).collect()[0, 0])

    def score(self, r: DsArray, y=None) -> float:
        """Negative reconstruction RMSE (higher is better)."""
        del y
        self._check_fitted("u_")
        with self._driver_scope():
            return -self._rmse(self._validate_x(r), self.u_, self.v_)


# ---------------------------------------------------------------------------
# Dataset-baseline ALS: identical math, but the column pass must build the
# transposed Dataset via the N^2+N task path (the paper's bottleneck).
# Host NumPy, as the reference's.
# ---------------------------------------------------------------------------


def als_dataset(ds: Dataset, n_factors: int = 16, reg: float = 0.1,
                max_iter: int = 10, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    r = ds.collect()
    n, m = r.shape
    u = rng.normal(size=(n, n_factors)).astype(r.dtype) * 0.1
    v = rng.normal(size=(m, n_factors)).astype(r.dtype) * 0.1
    ds_t = ds.transpose()  # N^2 + N tasks, 2x memory (the paper's complaint)
    for _ in range(max_iter):
        vg = np.linalg.inv(v.T @ v + reg * np.eye(n_factors, dtype=r.dtype))
        partial_u = ds.map_subsets(lambda x: x @ v)
        u = np.concatenate(partial_u, axis=0) @ vg
        ug = np.linalg.inv(u.T @ u + reg * np.eye(n_factors, dtype=r.dtype))
        partial_v = ds_t.map_subsets(lambda x: x @ u)
        v = np.concatenate(partial_v, axis=0) @ ug
    return u, v
