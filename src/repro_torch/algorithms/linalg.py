"""Blocked linear algebra on ds-arrays (the port of ``repro.algorithms.linalg``).

* ``pca``        — top-k principal components by subspace (block power)
  iteration: the data matrix is touched ONLY through ds-array products
  (recorded as one lazy plan, the transpose folded into ``matmul_ta``) and
  a block-native row broadcast, so the ``(n, m)`` data never materializes
  as a global rank-2 tensor;
* ``frobenius``  — blocked norm;
* ``tsqr``       — tall-skinny QR: one batched ``torch.linalg.qr`` over the
  stacked block rows + a reduction tree over the R factors (the paper's
  Fig. 3 pattern applied to factorization).

The small QRs run with ``torch.linalg.qr`` on the array's device.  The
starting subspace of the power iteration comes from :func:`_initial_q`, a
``torch.Generator`` draw: torch cannot replay the reference's
``jax.random`` stream, so a test hands both packages the same start.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.blocking import BlockGrid, ceil_div
from repro_torch.core.dsarray import PAD_ZERO, DsArray, from_array
from repro_torch.estimators.base import BaseEstimator


def frobenius(a: DsArray) -> float:
    return float(torch.sqrt((a * a).sum()))


def _broadcast_rows(row: DsArray, n: int, bn: Optional[int] = None,
                    like: Optional[DsArray] = None) -> DsArray:
    """(1, m) -> (n, m) ds-array with the row repeated, block-natively: the
    (1, bm) row tile is broadcast straight into the stacked layout, and only
    the pad rows of the last block row are masked (never a ``collect`` and
    re-block).  With a distributed ``like`` (the array it is combined with)
    the result is placed as ``like`` is and each rank broadcasts into its
    own shard only."""
    from repro_torch.core.structural import _mask_axes
    if row.shape[0] != 1:
        raise ValueError(f"_broadcast_rows wants a (1, m) row, got {row.shape}")
    if like is not None and like.is_distributed:
        return _broadcast_rows_placed(row, n, like)
    row = row.ensure_zero_pad()
    m = row.shape[1]
    bm = row.block_shape[1]
    bn = bn or min(max(1, n), 512)
    gn = max(1, ceil_div(n, bn))
    tile = row.blocks[:1]                          # (1, gm, 1, bm)
    blocks = tile.expand(gn, tile.shape[1], bn, bm)
    if gn * bn > n:                                # zero the broadcast pad rows
        blocks = _mask_axes(blocks, n=n)
    return DsArray(blocks, BlockGrid((n, m), (bn, bm)), PAD_ZERO)


def _broadcast_rows_placed(row: DsArray, n: int, like: DsArray) -> DsArray:
    """:func:`_broadcast_rows` placed as the distributed ``like`` (whose
    block rows it takes): this rank's shard of the broadcast, its rows past
    ``n`` zero."""
    from repro_torch.core import placement as pl
    row = row._gathered().ensure_zero_pad()
    loc = pl.local(like.blocks)
    gnl, gml, bn, bm = loc.shape
    r0, c0 = pl.offsets(like.blocks)
    tile = row.blocks[:1, c0:c0 + gml]                  # (1, <= gml, 1, bm)
    if tile.shape[1] < gml:                             # like's grid is padded
        tile = torch.nn.functional.pad(tile, (0, 0, 0, 0, 0, gml - tile.shape[1]))
    blocks = tile.expand(gnl, gml, bn, bm)
    if (r0 + gnl) * bn > n:                             # zero the pad rows
        rows = (r0 * bn + torch.arange(gnl * bn, device=loc.device)).reshape(gnl, 1, bn, 1)
        blocks = torch.where(rows < n, blocks, torch.zeros((), dtype=blocks.dtype,
                                                           device=loc.device))
    return DsArray(pl.rewrap(blocks, like.blocks),
                   BlockGrid((n, row.shape[1]), (bn, bm)), PAD_ZERO)


def _initial_q(m: int, k: int, seed: int, device) -> torch.Tensor:
    """The power iteration's starting ``(m, k)`` draw (standard normal, from
    a generator on ``device`` seeded with ``seed``), before its QR."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((m, k), generator=gen, device=device)


@dataclasses.dataclass
class PCA(BaseEstimator):
    """Estimator form of :func:`pca`: ``fit`` stores ``components_ (k, m)``
    and ``explained_variance_ (k,)``; ``transform`` projects through the
    block-native matmul (``sp @ dense`` for a sparse input — with
    ``center=False`` the data matrix is never densified, the TruncatedSVD
    convention); ``score`` is the mean explained variance of the kept
    subspace."""

    n_components: int = 2
    n_iter: int = 30
    seed: int = 0
    center: bool = True

    components_: Optional[torch.Tensor] = None
    explained_variance_: Optional[torch.Tensor] = None
    mean_: Optional[torch.Tensor] = None

    def fit(self, x, y=None) -> "PCA":
        del y
        with self._driver_scope():
            x = self._validate_x(x)
            if self.center:
                # the TRAINING mean is fitted state (transform centers new
                # data by it); center here, once, and hand pca() the result
                mean_row = x.mean(axis=0)
                self.mean_ = mean_row.collect().to(torch.float32)
                x = x - _broadcast_rows(mean_row, x.shape[0],
                                        x.block_shape[0], like=x)
            else:
                self.mean_ = None
            self.components_, self.explained_variance_ = pca(
                x, self.n_components, n_iter=self.n_iter, seed=self.seed,
                center=False)
        return self

    def transform(self, x) -> DsArray:
        """Project onto the fitted components (centered by the mean stored
        at fit): an (n, k) ds-array."""
        self._check_fitted("components_")
        with self._driver_scope():
            x = self._validate_x(x)
            comp = self.components_.to(x.device)
            if self.center:
                mean = from_array(self.mean_.reshape(1, -1),
                                  (1, x.block_shape[1]), device=x.device)
                x = x - _broadcast_rows(mean, x.shape[0], x.block_shape[0],
                                        like=x)
            w = from_array(comp.T, (x.block_shape[1], comp.shape[0]),
                           device=x.device)
            return x @ w

    def fit_transform(self, x, y=None) -> DsArray:
        return self.fit(x, y).transform(x)

    def score(self, x, y=None) -> float:
        del x, y
        self._check_fitted("components_")
        return float(torch.mean(self.explained_variance_))


def pca(x: DsArray, n_components: int, n_iter: int = 30, seed: int = 0,
        center: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k PCA of an (n_samples x n_features) ds-array.

    Returns (components (k, m), explained_variance (k,)).  Centers the data
    by the column mean through a block-native row broadcast, then runs
    orthogonal (power) iteration on the Gram operator.  The body
    ``xcᵀ @ (xc @ q)`` is recorded through the lazy layer: the optimizer
    folds the transpose into ``matmul_ta`` and the structurally identical
    plan is optimized ONCE and replayed every iteration; only the small
    ``(m, k)`` QR runs outside the plan.

    Sparse inputs: centering densifies (sparse − dense), so pass
    ``center=False``; the iteration then runs through ``spᵀ @ (sp @ q)``
    and the stored entries are never densified.
    """
    n, m = x.shape
    if center:
        mean = x.mean(axis=0)                     # (1, m) ds-array
        xc = x - _broadcast_rows(mean, n, x.block_shape[0], like=x)
    else:
        xc = x
    bq = (x.block_shape[1], n_components)
    dev = x.device

    xl = xc.lazy()
    q = torch.linalg.qr(_initial_q(m, n_components, seed, dev))[0]
    for _ in range(n_iter):
        y = (xl.T @ (xl @ from_array(q, bq, device=dev))).compute()  # (m, k)
        q = torch.linalg.qr(y.collect())[0]              # (m, k): small
    proj = xc @ from_array(q, bq, device=dev)            # (n, k)
    var = (proj * proj).sum(axis=0).collect().reshape(-1) / (n - 1)
    order = torch.argsort(-var, stable=True)
    return q.T[order], var[order]


def tsqr(x: DsArray) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tall-skinny QR: local QR per block row + an R-merge reduction tree.

    The leaf level is one batched ``torch.linalg.qr`` over the stacked
    block rows, on the device; the log-depth tree then works on (2m, m)
    stacks.  Requires m <= block rows and a (numerically) full-rank input;
    returns (q (n, m) dense, r (m, m)) on x's device.
    """
    n, m = x.shape
    if x.is_sparse:
        x = x.todense()    # per-block QR factors are dense whatever the input
    if x.block_shape[1] != m:
        x = x.rechunk((x.block_shape[0], m))
    x = x.ensure_zero_pad()
    bn = x.block_shape[0]
    gn = max(1, ceil_div(n, bn))
    stacked = x.blocks[:gn, 0]                     # (gn, bn, m), tail zero-pad
    # leaf level: one QR per block row, batched (the zero pad rows of the
    # tail block stay zero in Q = A R⁻¹ for a full-rank A)
    qs, rs = torch.linalg.qr(stacked)              # (gn, bn, m), (gn, m, m)
    level_q = list(qs.unbind(0))
    level_r = list(rs.unbind(0))
    del qs, rs
    # reduction tree over stacked R factors (paper Fig. 3), on the device
    while len(level_r) > 1:
        nq, nr = [], []
        for i in range(0, len(level_r) - 1, 2):
            pair = torch.cat([level_r[i], level_r[i + 1]], dim=0)
            q2, r2 = torch.linalg.qr(pair)
            nq.append((q2[:m], q2[m:]))
            nr.append(r2)
        merged_q = []
        for j, (qa, qb) in enumerate(nq):
            merged_q.append(torch.cat(
                [level_q[2 * j] @ qa, level_q[2 * j + 1] @ qb], dim=0))
        if len(level_r) % 2:
            merged_q.append(level_q[-1])
            nr.append(level_r[-1])
        level_q = merged_q
        level_r = nr
    return level_q[0][:n], level_r[0]              # drop the tail pad rows
