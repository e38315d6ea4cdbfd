"""Cascade SVM on ds-arrays (paper §6's target workload), the port of
``repro.estimators.csvm``.

The cascade (Graf et al. 2005, the algorithm dislib ships as CSVM): the
data is partitioned row-wise, each partition trains an SVM, and the
surviving support vectors merge pairwise up a reduction tree until one SV
set remains; that set is fed back into every partition and the cascade
repeats until the global model stops improving.

* **partitioning** — each level-0 chunk is a block-aligned row slice of the
  stacked blocks; for a sparse input that is a batch-dim slice of the
  stacked COO (``core.sparse.aligned_slice_sparse``): the data matrix is
  never densified on the way in;
* **per-node solves** — each node's (small) training set is its rows in
  dense form (``core.sparse.rows_to_dense``, an O(nnz) scatter of the
  stored entries on the device) and the dual solves by projected gradient
  ascent with the bias folded into an augmented kernel ``K + 1``: a loop of
  torch ops on the device of ``x``;
* **the recorded hot loop** — every cascade iteration evaluates the global
  kernel block ``K(X, SV) = X @ SVᵀ`` through ONE lazy plan (the SV panel
  padded to the static ``sv_cap``), so iterations 2..N skip the optimizer
  and reuse the cached run.  Its product is ``stacked_matmul`` for dense
  blocks and ``sparse_contract`` for sparse ones; RBF turns it into
  ``exp(-γ(‖x‖² − 2·X·SVᵀ + ‖sv‖²))`` on the device, with ``‖x‖²``
  computed once before the loop.

The duplicate collapse (:meth:`CascadeSVM._dedup`) runs on the host over
each candidate row's bytes, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sparse as sparse_mod
from repro_torch.core.blocking import ceil_div
from repro_torch.core.dsarray import DsArray, from_array
from repro_torch.estimators.base import (BaseClassifier, _iter_span,
                                         _no_checkpoints)

_SV_EPS = 1e-6           # dual weight below which a vector is not an SV
_POWER_ITERS = 12        # power iterations for the step size


def _solve_dual(b: torch.Tensor, y: torch.Tensor, mult: torch.Tensor,
                gamma: float, c: float, kernel: str,
                iters: int) -> torch.Tensor:
    """Dual SVM by projected gradient ascent on the augmented kernel.

    max  Σα − ½ αᵀ Q α,  0 ≤ α ≤ C·mult,   Q = (y yᵀ) ∘ (K + 1)

    The ``+ 1`` embeds the bias as a constant feature, so the equality
    constraint of the classic dual disappears and the box projection is
    exact; the bias recovers as ``b = Σ α y``.  The step size is 1/λmax(Q)
    from a short power iteration.  ``mult`` is the per-candidate
    multiplicity: 0 masks padded/duplicate slots out of the model, and a
    sample stored k times collapses to one slot with box k·C.  Runs on the
    device of ``b`` with no host sync.
    """
    s = b.shape[0]
    if kernel == "rbf":
        sq = torch.sum(b * b, dim=1)
        k = torch.exp(-gamma * torch.clamp(
            sq[:, None] - 2.0 * (b @ b.T) + sq[None, :], min=0.0))
    else:
        k = b @ b.T
    q = (y[:, None] * y[None, :]) * (k + 1.0)
    v = torch.full((s,), 1.0 / math.sqrt(s), dtype=b.dtype, device=b.device)
    for _ in range(_POWER_ITERS):
        w = q @ v
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-12)
    eta = 1.0 / torch.clamp(v @ (q @ v), min=1e-6)
    box = c * mult
    a = torch.zeros((s,), dtype=b.dtype, device=b.device)
    floor = torch.zeros_like(box)
    for _ in range(iters):
        a = torch.clamp(a + eta * (1.0 - q @ a), min=floor, max=box)
    return a


def _chunk_bounds(n: int, bn: int, n_chunks: int) -> List[Tuple[int, int]]:
    """Block-aligned row ranges covering [0, n): each chunk owns a whole
    number of block rows (so sparse chunks stay batch-dim slices)."""
    gn = max(1, ceil_div(n, bn))
    n_chunks = max(1, min(n_chunks, gn))
    per = ceil_div(gn, n_chunks)
    bounds = []
    for i in range(0, gn, per):
        r0, r1 = i * bn, min((i + per) * bn, n)
        if r1 > r0:
            bounds.append((r0, r1))
    return bounds


@dataclasses.dataclass
class CascadeSVM(BaseClassifier):
    """dislib-style cascade SVM: ``CascadeSVM(...).fit(x, y)`` with ``x`` a
    dense or sparse ds-array and binary ``y``.

    ``sv_cap`` is the static support-vector capacity of the model (and of
    every cascade node's output): it keeps every fed-back shape static,
    which lets the per-iteration recorded plan hit the caches.  A cap below
    the problem's true support size truncates the dual, so size it
    generously for hard data.  The fitted ``sv_``, ``sv_y_`` and
    ``dual_coef_`` are tensors on the device of the fitted input.
    """

    c: float = 1.0
    kernel: str = "rbf"               # "rbf" | "linear"
    gamma: object = "scale"           # float | "scale" → 1/(m·Var(x)) |
                                      # "auto" → 1/m (sklearn's names)
    cascade_arity: int = 2
    n_chunks: Optional[int] = None    # default: one chunk per block row
    sv_cap: int = 64
    max_iter: int = 5
    tol: float = 1e-3
    solver_iters: int = 300

    sv_: Optional[torch.Tensor] = None        # (sv_cap, m) padded SV rows
    sv_y_: Optional[torch.Tensor] = None      # (sv_cap,) labels in {-1, 0, +1}
    dual_coef_: Optional[torch.Tensor] = None  # (sv_cap,) alpha (0 on pads)
    intercept_: float = 0.0
    gamma_: float = 0.0                   # resolved RBF width
    n_sv_: int = 0
    n_iter_: int = 0
    converged_: bool = False

    # -- per-node solve ------------------------------------------------------
    def _resolve_gamma(self, x: DsArray) -> float:
        """The RBF width as a number.  ``"scale"`` (``1/(m·Var(x))``) takes
        the variance from two whole-array reductions, sparse-native on a
        sparse x (implicit zeros are values of the distribution)."""
        n, m = x.shape
        if self.kernel != "rbf":
            return 0.0
        if self.gamma == "auto":
            return 1.0 / m
        if self.gamma == "scale":
            mean = float(x.mean())
            e2 = float((x * x).sum()) / (n * m)
            var = max(e2 - mean * mean, 1e-12)
            return 1.0 / (m * var)
        return float(self.gamma)

    @staticmethod
    def _dedup(b: np.ndarray, y: np.ndarray, mult: np.ndarray,
               is_data: np.ndarray) -> np.ndarray:
        """Collapse duplicate (row, label) candidates into one slot.

        Two kinds of duplicate reach a node: **copies** (feedback puts the
        global SV set into every level-0 chunk and merges concatenate
        children, so one vector arrives k times without being k samples)
        and **genuine repeated samples**, whose combined box really is k·C.
        Data rows precede model copies in every node's layout, so data-data
        duplicates ACCUMULATE multiplicity onto the first slot, while any
        duplicate involving a model copy zeroes the copy.  Shapes are
        untouched — only ``mult`` changes."""
        mult = mult.copy()
        seen: dict = {}
        for i in np.flatnonzero(mult > 0):
            key = (b[i].tobytes(), float(y[i]))
            j = seen.setdefault(key, i)
            if j != i:
                if is_data[i] and is_data[j]:
                    mult[j] += mult[i]
                mult[i] = 0.0
        return mult

    def _node_solve(self, b: torch.Tensor, y: torch.Tensor,
                    mult: torch.Tensor, is_data: np.ndarray, gamma: float):
        """Solve one cascade node and keep its top ``sv_cap`` support
        vectors, returned PADDED to the static capacity (device tensors)."""
        mult = torch.as_tensor(
            self._dedup(b.cpu().numpy(), y.cpu().numpy(), mult.cpu().numpy(),
                        is_data), device=b.device)
        alpha = _solve_dual(b, y, mult, gamma, float(self.c), self.kernel,
                            int(self.solver_iters))
        order = torch.argsort(-alpha, stable=True)[: self.sv_cap]
        k = order.numel()
        cap = self.sv_cap
        rows = b.new_zeros((cap, b.shape[1]))
        yy, aa, mm = (b.new_zeros((cap,)) for _ in range(3))
        rows[:k], yy[:k], aa[:k], mm[:k] = b[order], y[order], alpha[order], \
            mult[order]
        keep = aa > _SV_EPS * self.c
        zero = b.new_zeros(())
        return (rows, torch.where(keep, yy, zero), torch.where(keep, aa, zero),
                torch.where(keep, mm, zero))

    # -- the recorded global kernel block ------------------------------------
    def _kernel_block(self, xl, x: DsArray, sv: torch.Tensor,
                      x_sq: Optional[torch.Tensor]) -> torch.Tensor:
        """``K(X, SV)`` as an (n, sv_cap) tensor on x's device; the data-side
        contraction ``X @ SVᵀ`` runs as one recorded lazy plan (the sparse
        contraction for a sparse x, never densifying it) whose structure is
        identical every cascade iteration."""
        sv_ds = from_array(sv.T, (x.block_shape[1], self.sv_cap),
                           device=x.device)
        km = (xl @ sv_ds).compute().collect().to(torch.float32)  # (n, sv_cap)
        if self.kernel == "rbf":
            sv_sq = (sv * sv).sum(dim=1)
            km = torch.exp(-self.gamma_ * torch.clamp(
                x_sq[:, None] - 2.0 * km + sv_sq[None, :], min=0.0))
        return km

    def _decision_values(self, xl, x: DsArray,
                         x_sq: Optional[torch.Tensor]) -> torch.Tensor:
        km = self._kernel_block(xl, x, self.sv_, x_sq)
        return km @ (self.dual_coef_ * self.sv_y_) + self.intercept_

    def _decision(self, x) -> Tuple[torch.Tensor, DsArray]:
        """(decision values (n,) on x's device, validated x) — shared by
        decision_function and predict."""
        x = self._validate_x(x).ensure_zero_pad()
        return self._decision_values(x.lazy(), x, self._row_sq(x)), x

    def _row_sq(self, x: DsArray) -> Optional[torch.Tensor]:
        """Iteration-invariant ‖x‖² row norms for the RBF expansion (the
        sparse pair multiply + row sum on a sparse x), computed once,
        outside the recorded loop."""
        if self.kernel != "rbf":
            return None
        sq = (x * x).sum(axis=1)
        return sq.collect().reshape(-1).to(torch.float32)

    # -- fit -----------------------------------------------------------------
    def fit(self, x, y, checkpoint_dir: Optional[str] = None,
            resume: Optional[str] = None) -> "CascadeSVM":
        """Fit the cascade.  ``checkpoint_dir``/``resume`` (the reference's
        per-iteration fit checkpoints) are not ported yet and raise."""
        _no_checkpoints(self, checkpoint_dir, resume)
        with self._driver_scope():
            return self._fit(x, y)

    def _fit(self, x, y) -> "CascadeSVM":
        if self.kernel not in ("rbf", "linear"):
            raise ValueError(f"unknown kernel {self.kernel!r}")
        x, y_raw = self._validate_fit(x, y)
        x = x.ensure_zero_pad()
        yi = self._encode_labels(y_raw, n_classes=2)
        dev = x.device
        ypm = torch.as_tensor((2.0 * yi - 1.0).astype(np.float32), device=dev)
        n, m = x.shape
        cap = self.sv_cap
        gamma = self.gamma_ = self._resolve_gamma(x)
        bounds = _chunk_bounds(n, x.block_shape[0],
                               self.n_chunks if self.n_chunks else 1 << 30)
        x_sq = self._row_sq(x)
        xl = x.lazy()

        fb_rows = torch.zeros((cap, m), dtype=torch.float32, device=dev)
        fb_y = torch.zeros((cap,), dtype=torch.float32, device=dev)
        fb_mult = torch.zeros((cap,), dtype=torch.float32, device=dev)
        prev_obj = math.inf
        self.converged_ = False
        for it in range(1, self.max_iter + 1):
            with _iter_span(self, it):
                # level 0: every chunk (data, multiplicity 1 each) + the
                # fed-back global SV slot (model copies; static cap); each
                # chunk's dense rows are made for its solve and released
                sets = []
                for r0, r1 in bounds:
                    cb = sparse_mod.rows_to_dense(x[r0:r1]).to(torch.float32)
                    b = torch.cat([cb, fb_rows])
                    yy = torch.cat([ypm[r0:r1], fb_y])
                    mult = torch.cat([torch.ones(len(cb), device=dev), fb_mult])
                    is_data = np.concatenate([np.ones(len(cb), bool),
                                              np.zeros(cap, bool)])
                    sets.append(self._node_solve(b, yy, mult, is_data, gamma))
                # merge tree: arity-way concats of capped SV sets (all model
                # copies — cross-chunk duplicates collapse without accumulating)
                while len(sets) > 1:
                    nxt = []
                    for i in range(0, len(sets), self.cascade_arity):
                        grp = sets[i: i + self.cascade_arity]
                        if len(grp) == 1:
                            nxt.append(grp[0])
                            continue
                        b, yy, _, mult = (torch.cat([g[j] for g in grp])
                                          for j in range(4))
                        nxt.append(self._node_solve(
                            b, yy, mult, np.zeros(len(b), bool), gamma))
                    sets = nxt
                rows, yy, aa, mm = sets[0]
                keep = aa > _SV_EPS * self.c
                self.sv_, self.sv_y_, self.dual_coef_ = rows, yy, aa
                self.intercept_ = float((aa * yy).sum())   # b of the K+1 dual
                self.n_sv_ = int(keep.sum())
                self.n_iter_ = it
                # global convergence: hinge objective over ALL data through
                # the one recorded kernel-block plan
                dec = self._decision_values(xl, x, x_sq)
                obj = float(torch.clamp(1.0 - ypm * dec, min=0.0).sum())
                # no verdict until there is a previous objective to compare
                if math.isfinite(prev_obj) and \
                        abs(prev_obj - obj) <= self.tol * max(1.0, abs(prev_obj)):
                    self.converged_ = True
                    break
                prev_obj = obj
                fb_rows, fb_y, fb_mult = rows, yy, mm
        return self

    # -- inference -----------------------------------------------------------
    def decision_function(self, x) -> DsArray:
        """Signed margins as a new ``(n, 1)`` ds-array (positive →
        ``classes_[1]``)."""
        self._check_fitted("sv_")
        with self._driver_scope():
            dec, x = self._decision(x)
            return self._labels_ds(dec.to(torch.float32), x)

    def predict(self, x) -> DsArray:
        self._check_fitted("sv_")
        with self._driver_scope():
            dec, x = self._decision(x)
            classes = torch.as_tensor(self.classes_, device=dec.device)
            return self._labels_ds(torch.where(dec > 0, classes[1],
                                               classes[0]), x)
