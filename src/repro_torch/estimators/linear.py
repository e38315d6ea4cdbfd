"""Distributed linear models: LinearRegression / Ridge on ds-arrays (the port
of ``repro.estimators.linear``).

Fit goes through the **distributed normal equations**: ``XᵀX``, ``Xᵀy`` and
the column sums are recorded as ONE lazy plan — ``x.lazy().T @ x`` folds to
the transpose-absorbed GEMM (``matmul_ta``, the ``stacked_matmul`` kernel on
a card) and CSE shares the ``x`` leaf between the products — then the small
``(m+1, m+1)`` system solves on the host in float64.  A sparse ``x`` is the
stored-entry left operand of every product (``sparse_contract``; only the
right-hand copy of ``XᵀX`` takes its dense form).  The intercept is an
augmented row/column built from the column sums, NOT centering, so sparse
inputs stay sparse.

Ill-conditioned tall-skinny inputs: when ``alpha == 0`` and the Gram's
spectrum says ``cond(X) ≳ 1/√eps`` the fit falls back to **TSQR**
(``algorithms.linalg.tsqr``) and solves ``R θ = Qᵀ y``; Ridge
(``alpha > 0``) regularizes the Gram and keeps the one-plan path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import expr as _expr
from repro_torch.core import plan
from repro_torch.core.dsarray import DsArray, from_array
from repro_torch.estimators.base import BaseRegressor
from repro_torch.resilience.guards import (NumericalDivergence,
                                           require_finite_host)

# cond(X) beyond which the squared-cond normal equations lose f32 accuracy
# (cond(G) = cond(X)² ≳ 1/eps_f32 ≈ 1.7e7): fall back to TSQR
_COND_FALLBACK = 3e3
# rows of Q per float64 pass of Qᵀy on the device
_QTY_ROWS = 1 << 20


def _host64(a) -> np.ndarray:
    if isinstance(a, DsArray):
        a = a.collect()
    return a.detach().to(torch.float64).cpu().numpy()


@dataclasses.dataclass
class LinearRegression(BaseRegressor):
    """Ordinary least squares ``y = x @ coef_ + intercept_`` on ds-arrays.

    ``solver``: ``"auto"`` (normal equations, TSQR fallback when the Gram
    is ill-conditioned and ``alpha == 0``), ``"normal"``, or ``"tsqr"``
    (dense inputs only).  ``coef_`` is a host float64 vector.
    """

    fit_intercept: bool = True
    alpha: float = 0.0
    solver: str = "auto"

    coef_: Optional[np.ndarray] = None
    intercept_: float = 0.0
    n_features_in_: int = 0
    solver_used_: str = ""

    def _normal_stats(self, x: DsArray, y: np.ndarray):
        """(XᵀX, Xᵀy, colsums) via one recorded lazy plan: the optimizer
        folds both transposes into ``matmul_ta`` and CSE shares the single
        ``x`` leaf across all three roots."""
        y_ds = from_array(np.asarray(y, np.float32).reshape(-1, 1),
                          (x.block_shape[0], 1), device=x.device)
        xl = x.lazy()
        g = xl.T @ x
        c = xl.T @ y_ds
        s = xl.sum(axis=0)
        g_ds, c_ds, s_ds = plan.compute_multi(g, c, s)
        return (_host64(g_ds), _host64(c_ds).ravel(), _host64(s_ds).ravel())

    def _solve_normal(self, gram, xty, colsum, n, ysum):
        m = gram.shape[0]
        if self.fit_intercept:
            a = np.zeros((m + 1, m + 1))
            a[:m, :m] = gram
            a[:m, m] = colsum
            a[m, :m] = colsum
            a[m, m] = n
            b = np.concatenate([xty, [ysum]])
            reg = np.eye(m + 1) * self.alpha
            reg[m, m] = 0.0                      # never penalize the intercept
        else:
            a, b, reg = gram, xty, np.eye(m) * self.alpha
        try:
            theta = require_finite_host(np.linalg.solve(a + reg, b),
                                        "normal-equations solution")
        except (np.linalg.LinAlgError, NumericalDivergence):
            # rank-deficient Gram (all-zero feature columns are routine in
            # sparse data): the min-norm lstsq solution, like sklearn
            theta = np.linalg.lstsq(a + reg, b, rcond=None)[0]
        if self.fit_intercept:
            return theta[:m], float(theta[m])
        return theta, 0.0

    def _solve_tsqr(self, x: DsArray, y: np.ndarray):
        """QR path for ill-conditioned tall-skinny inputs: cond(R) ==
        cond(X), no squaring.  The intercept comes from centering (dense
        path only); ``alpha > 0`` factors the row-augmented system
        ``[X; √α·I]`` with zero-extended targets, so an explicit
        ``solver="tsqr"`` never drops the requested penalty.  ``Qᵀy`` runs
        in float64 on the device, a block of rows at a time."""
        from repro_torch.algorithms.linalg import _broadcast_rows, tsqr
        from repro_torch.core.dsarray import concat_rows
        if x.is_sparse:
            # QR factors are dense whatever the input; centering would
            # densify anyway — sparse callers keep the normal equations
            raise ValueError("tsqr solver supports dense inputs only")
        n, m = x.shape
        if n < m:
            raise ValueError("tsqr solver needs a tall (n >= m) input")
        if x.block_shape[0] < m:
            # tsqr's leaf QR needs m <= block rows: re-block (block-native)
            x = x.rechunk((min(n, max(x.block_shape[0], m)),
                           x.block_shape[1]))
        yv = np.asarray(y, np.float64)
        if self.fit_intercept:
            mean_row = x.mean(axis=0)
            xc = x - _broadcast_rows(mean_row, x.shape[0], x.block_shape[0])
            ym = yv.mean()
            yc = yv - ym
        else:
            xc, yc, ym = x, yv, 0.0
        if self.alpha > 0.0:
            ridge_rows = from_array(
                np.sqrt(self.alpha) * np.eye(m, dtype=np.float32),
                xc.block_shape, device=x.device)
            xc = concat_rows([xc, ridge_rows])
            yc = np.concatenate([yc, np.zeros(m)])
        q, r = tsqr(xc)
        y_dev = torch.as_tensor(yc, dtype=torch.float64, device=q.device)
        qty = sum(q[lo:lo + _QTY_ROWS].T.to(torch.float64)
                  @ y_dev[lo:lo + _QTY_ROWS]
                  for lo in range(0, q.shape[0], _QTY_ROWS))
        qty, r64 = _host64(qty), _host64(r)
        del q
        try:
            coef = require_finite_host(np.linalg.solve(r64, qty),
                                       "tsqr R-solve solution")
        except (np.linalg.LinAlgError, NumericalDivergence):
            # singular R (exactly collinear/zero columns): min-norm solve
            coef = np.linalg.lstsq(r64, qty, rcond=None)[0]
        if self.fit_intercept:
            mean = _host64(mean_row).ravel()
            return coef, float(ym - mean @ coef)
        return coef, 0.0

    def fit(self, x, y) -> "LinearRegression":
        with self._driver_scope():
            return self._fit(x, y)

    def _fit(self, x, y) -> "LinearRegression":
        x, y = self._validate_fit(x, y)
        n, m = x.shape
        self.n_features_in_ = m
        if self.solver not in ("auto", "normal", "tsqr"):
            raise ValueError(f"unknown solver {self.solver!r}")
        solver = self.solver
        gram = xty = colsum = None
        if solver != "tsqr":
            gram, xty, colsum = self._normal_stats(x, y)
            if solver == "auto" and self.alpha == 0.0 and not x.is_sparse \
                    and n >= m:
                ev = np.linalg.eigvalsh(gram)
                lo, hi = max(float(ev[0]), 0.0), float(ev[-1])
                # cond(X) = sqrt(cond(XᵀX)); degenerate spectrum → fallback
                if lo <= 0 or np.sqrt(hi / lo) > _COND_FALLBACK:
                    solver = "tsqr"
                else:
                    solver = "normal"
            elif solver == "auto":
                solver = "normal"
        if solver == "tsqr":
            self.coef_, self.intercept_ = self._solve_tsqr(x, y)
        else:
            self.coef_, self.intercept_ = self._solve_normal(
                gram, xty, colsum, n, float(np.asarray(y, np.float64).sum()))
        self.solver_used_ = solver
        return self

    def _weights_ds(self, block_cols: int, device) -> DsArray:
        """``coef_`` as an ``(m, 1)`` ds-array on ``device``, cached per
        column blocking, device AND fitted-coefficient identity: re-recorded
        predicts reuse ONE leaf array (a stable plan structure, no copy to
        the device per call), and a refit (a new ``coef_`` object)
        invalidates the entry."""
        cache = self.__dict__.setdefault("_predict_cache", {})
        key = (int(block_cols), str(device), id(self.coef_))
        w = cache.get(key)
        if w is None:
            cache.clear()                    # one fit, one blocking at a time
            w = from_array(np.asarray(self.coef_, np.float32).reshape(-1, 1),
                           (block_cols, 1), device=device)
            cache[key] = w
        return w

    def _predict_expr(self, xl):
        """``x @ coef_ + intercept_`` recorded on the lazy input: the
        product is ``sp @ dense`` for a sparse input, and the whole
        expression is one cacheable plan."""
        out = xl @ self._weights_ds(xl.block_shape[1],
                                    _expr._device_of(xl.expr))
        if self.intercept_ != 0.0:
            out = out + float(self.intercept_)
        return out

    def predict(self, x) -> DsArray:
        """``x @ coef_ + intercept_`` as a new ``(n, 1)`` ds-array, through
        the recorded plan of :meth:`_predict_expr`."""
        self._check_fitted("coef_")
        with self._driver_scope():
            x = self._validate_x(x)
            return plan.compute(self._predict_expr(x.lazy()))


@dataclasses.dataclass
class Ridge(LinearRegression):
    """L2-regularized linear regression: the Gram gets ``alpha`` added to
    its diagonal (intercept unpenalized), which also keeps the normal
    equations well-posed on rank-deficient inputs — so Ridge never needs
    the TSQR fallback."""

    alpha: float = 1.0
