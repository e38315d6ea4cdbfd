"""Sparse blocks for ds-arrays: one stacked COO over the block grid (the
port of ``repro.core.sparse``).

The paper's ds-array stores each block as EITHER a NumPy array or a
scipy.sparse CSR matrix, and the NumPy-like API keeps working over both.
The reference swaps its rank-4 dense tensor for one
``jax.experimental.sparse.BCOO`` with two batch dims; the port swaps it for
a :class:`StackedCOO` of the same layout:

* ``data (gn, gm, nse)`` and ``indices (gn, gm, nse, 2)`` int32 — the grid
  dims first, then the stored entries of each block, with block-local
  ``(row, col)`` indices;
* ``nse`` is the entry capacity of every block; a block with fewer entries
  fills its slots with the out-of-bounds sentinel ``(bn, bm)`` and zero
  data.  Explicit zero-data slots count as absent;
* ``indices_sorted`` (entries of each block in (row, col) order, sentinels
  last) and ``unique_indices`` (no in-bounds position twice) are claims the
  constructors make and the ops carry.

``DsArray.block_format`` names the storage: ``"dense"`` for the rank-4
tensor, ``"bcoo"`` for the stacked COO.  A sparse array owns no entry in the
pad region, so it is ZERO-padded by construction and every sparse-producing
op keeps that (data maps are gated on ``fn(0) == 0``).

Op policy (as the reference's, see ``core.dsarray``):

* **sparse-native** — scalar scale/neg/abs/sqrt (index-preserving data
  maps), sp ± sp (entry lists concatenated: nse adds up), sp * sp (the
  canonical index lists intersected block by block: capacity
  ``min(nse_l, nse_r)``), sp * dense and sp / dense (the dense operand
  gathered at the stored indices), ``astype``, ``transpose`` (an O(nnz)
  index swap), grid padding, ``sum``, ``sp @ dense`` and ``spᵀ @ dense``
  (``kernels.matmul.ops.sparse_contract``: the sparse operand is never
  densified);
* **densifying** — ops that break the implicit-zero algebra (``+ scalar``,
  ``exp``, dense / sp), max/min, and the structural ops other than the
  block-aligned slice.

Everything runs on the device of the input tensors with torch ops; sums
over stored entries are deterministic (sorted segments reduced in order,
never float atomics), so the same call gives the same bits.  Each op has a
shape-only path for ``meta`` tensors, which the lazy layer's metadata
inference runs.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blocking import BlockGrid, ceil_div

FORMAT_DENSE = "dense"
FORMAT_BCOO = "bcoo"

_RECOVERABLE = (TypeError, ValueError, RuntimeError, ZeroDivisionError)


class StackedCOO:
    """The stacked COO block tensor of a sparse ds-array (see the module
    docstring); the counterpart of the reference's 2-batch-dim BCOO."""

    __slots__ = ("data", "indices", "shape", "indices_sorted", "unique_indices")

    def __init__(self, data: torch.Tensor, indices: torch.Tensor,
                 shape: Tuple[int, int, int, int], indices_sorted: bool = False,
                 unique_indices: bool = False):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 4:
            raise ValueError(f"stacked COO shape must be rank 4, got {shape}")
        if data.ndim != 3 or tuple(data.shape[:2]) != shape[:2]:
            raise ValueError(f"data {tuple(data.shape)} does not fit the grid "
                             f"of {shape}")
        if tuple(indices.shape) != tuple(data.shape) + (2,):
            raise ValueError(f"indices {tuple(indices.shape)} do not match data "
                             f"{tuple(data.shape)}")
        if indices.dtype != torch.int32:
            raise TypeError(f"indices must be int32, got {indices.dtype}")
        if data.device != indices.device:
            raise ValueError(f"data on {data.device}, indices on {indices.device}")
        self.data = data
        self.indices = indices
        self.shape = shape
        self.indices_sorted = bool(indices_sorted)
        self.unique_indices = bool(unique_indices)

    @property
    def nse(self) -> int:
        return int(self.data.shape[2])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def ndim(self) -> int:
        return 4

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"StackedCOO(shape={self.shape}, nse={self.nse}, "
                f"dtype={self.dtype}, device={self.device})")


def _is_meta(sp: StackedCOO) -> bool:
    return sp.data.device.type == "meta"


def _rebuild(ref: StackedCOO, data: torch.Tensor,
             indices: Optional[torch.Tensor] = None) -> StackedCOO:
    """``ref``'s index structure (and its flags) with new ``data``."""
    return StackedCOO(data, ref.indices if indices is None else indices,
                      ref.shape, ref.indices_sorted, ref.unique_indices)


def _empty_coo(shape, nse: int, dtype, device) -> StackedCOO:
    """A stacked COO of ``shape`` with ``nse`` sentinel slots of zero data
    in every block (on a ``meta`` device: shapes only)."""
    gn, gm, bn, bm = shape
    data = torch.zeros((gn, gm, nse), dtype=dtype, device=device)
    idx = torch.tensor([bn, bm], dtype=torch.int32, device=device)
    return StackedCOO(data, idx.expand(gn, gm, nse, 2).contiguous(), shape,
                      True, True)


def _empty_like(sp: StackedCOO, nse: int, dtype=None) -> StackedCOO:
    return _empty_coo(sp.shape, nse, dtype or sp.dtype, sp.device)


def _valid(sp: StackedCOO) -> torch.Tensor:
    """(gn, gm, nse) bool: the slot holds an in-bounds index."""
    bn, bm = sp.shape[2:]
    return (sp.indices[..., 0] < bn) & (sp.indices[..., 1] < bm)


def _acc_dtype(*dtypes) -> torch.dtype:
    """The type sums over stored entries run in: float32 for floats of at
    most 32 bits, float64 for float64 and for integers and bool (exact for
    sums below 2**53; ``torch.segment_reduce`` takes floats only)."""
    if all(d.is_floating_point and d.itemsize <= 4 for d in dtypes):
        return torch.float32
    return torch.float64


def _sum_duplicates(sp: StackedCOO, nse: Optional[int] = None) -> StackedCOO:
    """``sp`` with the entries of each in-bounds position summed into one
    slot, sorted by (row, col), sentinels last, at capacity ``nse`` (default:
    the most distinct positions any block holds, a host sync; explicit
    zero-data entries count).  A smaller ``nse`` drops the last positions.

    Per block row: one stable sort of the linear keys, the slots of each
    key summed in their stored order (``segment_reduce``), so the result is
    the same bits on every run."""
    gn, gm, bn, bm = sp.shape
    n_slots = sp.nse
    if _is_meta(sp) or n_slots == 0:
        if nse is None and n_slots:
            raise ValueError("the capacity of a merged sparse array is data "
                             "dependent: pass nse= (lazy plans) or run eagerly")
        return _empty_like(sp, int(nse or 0))
    sentinel = bn * bm
    acc = _acc_dtype(sp.dtype)
    rows_data, rows_keys, uniques = [], [], []
    for gi in range(gn):
        idx = sp.indices[gi].long()                      # (gm, n)
        keys = torch.where((idx[..., 0] < bn) & (idx[..., 1] < bm),
                           idx[..., 0] * bm + idx[..., 1], sentinel)
        sk, perm = torch.sort(keys, dim=1, stable=True)
        sd = sp.data[gi].gather(1, perm).to(acc)
        # a group per distinct key; every sentinel slot a group of its own,
        # so no reduction runs serially over a block's pad slots
        first = torch.ones_like(sk, dtype=torch.bool)
        first[:, 1:] = (sk[:, 1:] != sk[:, :-1]) | (sk[:, 1:] == sentinel)
        grp = torch.cumsum(first, dim=1) - 1             # group id in its block
        flat = (torch.arange(gm, device=sp.device)[:, None] * n_slots
                + grp).reshape(-1)
        lengths = torch.bincount(flat, minlength=gm * n_slots)
        sums = torch.segment_reduce(sd.reshape(-1), "sum", lengths=lengths,
                                    unsafe=True).reshape(gm, n_slots)
        out_keys = torch.full((gm, n_slots), sentinel, dtype=torch.int64,
                              device=sp.device)
        out_keys.scatter_(1, grp, sk)                    # one key per group
        rows_data.append(sums.to(sp.dtype))
        rows_keys.append(out_keys)
        uniques.append((out_keys < sentinel).sum(dim=1))
    nse = int(torch.stack(uniques).max()) if nse is None else int(nse)
    data, keys = torch.stack(rows_data), torch.stack(rows_keys)
    if nse <= n_slots:
        data, keys = data[..., :nse], keys[..., :nse]
    else:
        extra = nse - n_slots
        data = torch.cat([data, data.new_zeros((gn, gm, extra))], dim=2)
        keys = torch.cat([keys, keys.new_full((gn, gm, extra), sentinel)], dim=2)
    oob = keys >= sentinel
    data = torch.where(oob, torch.zeros((), dtype=data.dtype, device=data.device),
                       data)
    indices = torch.stack([torch.where(oob, bn, keys // bm),
                           torch.where(oob, bm, keys % bm)], dim=-1)
    return StackedCOO(data.contiguous(), indices.to(torch.int32), sp.shape,
                      True, True)


def _canon_unique(sp: StackedCOO) -> StackedCOO:
    """``sp`` with duplicate indices merged (same capacity).

    sp ± sp CONCATENATES entry lists, so one position may be split across
    slots; a NONLINEAR data map over split entries is wrong
    (``|d1 + d2| != |d1| + |d2|``), so every nonlinear consumer merges
    first; linear maps (scale, gather-mul) distribute over the split."""
    if sp.unique_indices:
        return sp
    return _sum_duplicates(sp, nse=sp.nse)


def _canonical(sp: StackedCOO) -> StackedCOO:
    """``sp`` sorted and merged (same capacity): what the intersection of
    two index lists searches in."""
    if sp.unique_indices and sp.indices_sorted:
        return sp
    return _sum_duplicates(sp, nse=sp.nse)


_LINEAR_DATA_OPS = {"mul", "true_divide"}


def _gather_dense_at(sp: StackedCOO, dense_blocks: torch.Tensor) -> torch.Tensor:
    """The dense stacked tensor's values at ``sp``'s stored positions, shape
    ``(gn, gm, nse)``; sentinel slots read a clamped position (their data is
    zero, so the value read does not matter)."""
    gn, gm, bn, bm = sp.shape
    ii = sp.indices[..., 0].long().clamp(max=bn - 1)
    jj = sp.indices[..., 1].long().clamp(max=bm - 1)
    bi = torch.arange(gn, device=sp.device)[:, None, None]
    bj = torch.arange(gm, device=sp.device)[None, :, None]
    return dense_blocks[bi, bj, ii, jj]


def _to_dense_blocks(sp: StackedCOO) -> torch.Tensor:
    """The dense ``(gn, gm, bn, bm)`` tensor of ``sp``: merged entries
    written into zeros, so the pad is exactly zero."""
    if _is_meta(sp):
        return torch.empty(sp.shape, dtype=sp.dtype, device="meta")
    sp = _canon_unique(sp)
    gn, gm, bn, bm = sp.shape
    out = torch.zeros(sp.shape, dtype=sp.dtype, device=sp.device)
    ok = _valid(sp)
    bi = torch.arange(gn, device=sp.device)[:, None, None].expand_as(ok)
    bj = torch.arange(gm, device=sp.device)[None, :, None].expand_as(ok)
    idx = sp.indices.long()
    out[bi[ok], bj[ok], idx[..., 0][ok], idx[..., 1][ok]] = sp.data[ok]
    return out


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------


def _pack_coo_arrays(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                     cell: torch.Tensor, n_cells: int, bn: int, bm: int,
                     nse: Optional[int] = None, check_nse: bool = True,
                     device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucket block-sorted COO triplets into ``(data (n_cells, nse),
    indices (n_cells, nse, 2))`` on ``device``.  ``cell`` is non-decreasing;
    ``rows``/``cols`` are block-local.  Short cells fill with the sentinel
    ``(bn, bm)`` and zero data.  With ``check_nse`` an explicit capacity
    below the densest cell raises instead of silently dropping entries."""
    from repro_torch.core.dsarray import resolve_device
    dev = resolve_device(device)
    rows, cols, vals, cell = (t.to(dev) for t in (rows, cols, vals, cell))
    cell = cell.long()
    counts = torch.bincount(cell, minlength=n_cells)
    maxn = int(counts.max()) if counts.numel() else 0
    if nse is None:
        nse = maxn
    nse = max(1, int(nse))
    if check_nse and maxn > nse:
        raise ValueError(
            f"nse={nse} cannot hold the densest block ({maxn} nnz); "
            f"entries would be silently dropped.  Pass nse>=max_block_nnz "
            f"or check_nse=False if the capacity was already verified.")
    data = torch.zeros((n_cells, nse), dtype=vals.dtype, device=dev)
    indices = torch.tensor([bn, bm], dtype=torch.int32, device=dev).repeat(
        n_cells, nse, 1)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(cell.numel(), device=dev) - starts[cell]
    if maxn > nse:                     # an unchecked explicit nse truncates
        keep = slot < nse
        cell, slot, rows, cols, vals = (t[keep] for t in
                                        (cell, slot, rows, cols, vals))
    data[cell, slot] = vals
    indices[cell, slot, 0] = rows.to(torch.int32)
    indices[cell, slot, 1] = cols.to(torch.int32)
    return data, indices


def _pack_coo(rows, cols, vals, cell, gn: int, gm: int, bn: int, bm: int,
              nse: Optional[int] = None, check_nse: bool = False,
              device="cuda") -> StackedCOO:
    """Block-sorted COO triplets as the stacked COO (``cell = gi*gm + gj``;
    within a cell, triplets in (row, col) order); see
    :func:`_pack_coo_arrays`."""
    data, indices = _pack_coo_arrays(rows, cols, vals, cell, gn * gm, bn, bm,
                                     nse, check_nse, device)
    nse = data.shape[1]
    return StackedCOO(data.reshape(gn, gm, nse), indices.reshape(gn, gm, nse, 2),
                      (gn, gm, bn, bm), indices_sorted=True, unique_indices=True)


def tosparse(a: "DsArray", nse: Optional[int] = None) -> "DsArray":
    """Dense ds-array -> sparse (identity if already sparse), on ``a``'s
    device.  The pad is zeroed first, so no pad position owns an entry.
    ``nse`` caps the stored entries per block (default: the max block nnz,
    a host sync); a smaller explicit ``nse`` drops each block's last
    entries, as the reference's."""
    from repro_torch.core.dsarray import PAD_ZERO, DsArray
    if a.block_format == FORMAT_BCOO:
        return a
    me = a.ensure_zero_pad()
    blocks = me.blocks
    gn, gm, bn, bm = blocks.shape
    if blocks.device.type == "meta":
        if nse is None:
            raise ValueError("tosparse needs nse= on a meta tensor")
        return DsArray(_empty_coo(blocks.shape, int(nse), blocks.dtype, "meta"),
                       a.grid, PAD_ZERO)
    nz = torch.nonzero(blocks)                      # C order: block by block
    vals = blocks[blocks != 0]
    sp = _pack_coo(nz[:, 2], nz[:, 3], vals, nz[:, 0] * gm + nz[:, 1],
                   gn, gm, bn, bm, nse, device=blocks.device)
    return DsArray(sp, a.grid, PAD_ZERO)


def todense(a: "DsArray") -> "DsArray":
    """Sparse ds-array -> dense (identity if already dense): the merged
    entries written into a zero tensor, so the result pad is exactly zero."""
    from repro_torch.core.dsarray import PAD_ZERO, DsArray
    if a.block_format == FORMAT_DENSE:
        return a
    return DsArray(_to_dense_blocks(a.blocks), a.grid, PAD_ZERO)


def density(a: "DsArray") -> float:
    """Stored nonzeros over the logical size."""
    n, m = a.shape
    if a.block_format == FORMAT_BCOO:
        nnz = int(torch.count_nonzero(a.blocks.data))
    else:
        nnz = int(torch.count_nonzero(a.ensure_zero_pad().blocks))
    return nnz / max(1, n * m)


def canonicalize(a: "DsArray", nse: Optional[int] = None) -> "DsArray":
    """Re-pack a sparse ds-array: merge duplicate indices (left by sp + sp)
    and shrink ``nse`` to the most positions any block holds.  With
    ``nse=None`` eager only (the capacity is data dependent)."""
    from repro_torch.core.dsarray import PAD_ZERO, DsArray
    if a.block_format != FORMAT_BCOO:
        return a
    return DsArray(_sum_duplicates(a.blocks, nse=nse), a.grid, PAD_ZERO)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def random_sparse(generator: torch.Generator, shape: Tuple[int, int],
                  block_shape: Tuple[int, int], density: float = 0.01,
                  dtype=torch.float32, distribution: str = "normal",
                  device="cuda") -> "DsArray":
    """Random sparse ds-array: every block stores ``ceil(density·bn·bm)``
    distinct positions drawn uniformly from ``generator`` (which must live
    on ``device``) with standard normal or uniform [0, 1) values; entries
    that land in the pad region get zero data.  Held to its distribution,
    not to the reference's random bits.  Draws one key per block position,
    so it costs O(dense size) on the device; ``from_scipy`` builds larger
    arrays."""
    from repro_torch.core.dsarray import PAD_ZERO, DsArray, resolve_device
    dev = resolve_device(device)
    grid = BlockGrid(tuple(shape), tuple(block_shape))
    gn, gm, bn, bm = grid.stacked_shape
    nse = math.ceil(float(density) * bn * bm)
    keys = torch.rand((gn, gm, bn * bm), generator=generator, device=dev)
    pos = torch.sort(torch.topk(keys, nse, dim=-1).indices, dim=-1).values
    sampler = {"normal": torch.randn, "uniform": torch.rand}[distribution]
    data = sampler((gn, gm, nse), generator=generator, device=dev).to(dtype)
    rows, cols = pos // bm, pos % bm
    n, m = shape
    gi = torch.arange(gn, device=dev)[:, None, None]
    gj = torch.arange(gm, device=dev)[None, :, None]
    valid = (gi * bn + rows < n) & (gj * bm + cols < m)
    data = torch.where(valid, data, torch.zeros((), dtype=dtype, device=dev))
    indices = torch.stack([rows, cols], dim=-1).to(torch.int32)
    return DsArray(StackedCOO(data, indices, (gn, gm, bn, bm), True, True),
                   grid, PAD_ZERO)


def _csr_canonical(mat):
    """``mat`` as a CSR matrix with sorted, merged indices; the caller's
    matrix is not modified."""
    csr = mat.tocsr()
    if not csr.has_canonical_format:
        csr = csr.copy()
        csr.sum_duplicates()
    return csr


def from_scipy(mat, block_shape: Tuple[int, int], nse: Optional[int] = None,
               check_nse: bool = True, device="cuda") -> "DsArray":
    """scipy.sparse matrix -> sparse ds-array on ``device``, never dense.

    The (row, col, value) triplets, in row-major order, go to the device
    and are bucketed there by block (one stable sort of the int64 block id)
    into the stacked COO at ``nse`` = the max block nnz.  An explicit
    ``nse`` fixes the capacity instead; below the real max it raises
    ``ValueError`` unless ``check_nse=False``.  Values are narrowed to 32
    bits (float64 -> float32, int64 -> int32) as ``from_array`` does."""
    from repro_torch.core.dsarray import _NARROW, PAD_ZERO, DsArray, resolve_device
    dev = resolve_device(device)
    csr = _csr_canonical(mat)
    n, m = csr.shape
    grid = BlockGrid((n, m), tuple(block_shape))
    gn, gm, bn, bm = grid.stacked_shape
    counts = np.diff(csr.indptr)
    rows = torch.from_numpy(np.repeat(np.arange(n, dtype=np.int64), counts)).to(dev)
    cols = torch.from_numpy(csr.indices.astype(np.int64, copy=False)).to(dev)
    vals = torch.from_numpy(np.ascontiguousarray(csr.data))
    vals = vals.to(device=dev, dtype=_NARROW.get(vals.dtype, vals.dtype))
    cell = (rows // bn) * gm + cols // bm
    cell, order = torch.sort(cell, stable=True)
    sp = _pack_coo(rows[order] % bn, cols[order] % bm, vals[order], cell,
                   gn, gm, bn, bm, nse, check_nse=check_nse, device=dev)
    return DsArray(sp, grid, PAD_ZERO)


def max_block_nnz(mat, block_shape: Tuple[int, int]) -> int:
    """Max nnz of any block of ``mat`` under ``block_shape`` (host NumPy over
    the stored triplets only): the guard a fixed-capacity ``from_scipy``
    pack needs."""
    csr = _csr_canonical(mat)
    if csr.nnz == 0:
        return 0
    n, m = csr.shape
    gn, gm, bn, bm = BlockGrid((n, m), tuple(block_shape)).stacked_shape
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr))
    cell = (rows // bn) * gm + csr.indices.astype(np.int64) // bm
    return int(np.bincount(cell, minlength=gn * gm).max())


class StackedBCOOBuilder:
    """Incremental stacked-COO assembly, one block row at a time, on
    ``device``.

    Each completed block row's triplets are bucketed by block column (sorted
    by (row, col) inside each block, so ``indices_sorted`` holds) and moved
    to the device at once: host memory stays O(one block row).  With
    ``nse=None`` every row packs at its own max block nnz and
    :meth:`finalize` pads every row to the global max (the ``from_scipy``
    capacity); an explicit ``nse`` fixes the capacity and an overflowing row
    raises ``ValueError`` when it is appended."""

    def __init__(self, m: int, block_shape: Tuple[int, int],
                 dtype=torch.float32, nse: Optional[int] = None, device="cuda"):
        from repro_torch.core.dsarray import resolve_device
        self.bn, self.bm = int(block_shape[0]), int(block_shape[1])
        self.m = int(m)
        self.gm = max(1, ceil_div(self.m, self.bm))
        self.dtype = dtype
        self.nse = None if nse is None else max(1, int(nse))
        self.device = resolve_device(device)
        self.n_rows = 0                       # logical rows appended so far
        self._data: list = []                 # per block row: (gm, nse_i)
        self._indices: list = []              # per block row: (gm, nse_i, 2)

    def append_blockrow(self, rows, cols, vals, n_rows: int) -> None:
        """Add one block row from triplets (``rows`` block-local in
        [0, bn), ``cols`` global in [0, m), any order)."""
        if not 0 < n_rows <= self.bn:
            raise ValueError(f"n_rows={n_rows} outside (0, bn={self.bn}]")
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        if cols.size and (int(cols.max()) >= self.m or int(cols.min()) < 0):
            raise ValueError(
                f"feature id {int(cols.max())} out of range for "
                f"n_features={self.m} (0-based after shift — a 0-based "
                f"file read as 1-based hits this)")
        cell = cols // self.bm
        # sort by (block, row, col) so indices_sorted holds (int64 key:
        # gm*bn*bm can pass 2**31)
        order = np.argsort(cell * (self.bn * self.bm) + rows * self.bm
                           + cols % self.bm, kind="stable")
        vals = torch.as_tensor(np.asarray(vals)[order]).to(self.dtype)
        data, indices = _pack_coo_arrays(
            torch.from_numpy(rows[order]), torch.from_numpy(cols[order] % self.bm),
            vals, torch.from_numpy(cell[order]), self.gm, self.bn, self.bm,
            nse=self.nse, check_nse=True, device=self.device)
        self._data.append(data)
        self._indices.append(indices)
        self.n_rows += int(n_rows)

    def finalize(self) -> "DsArray":
        """Stack the appended block rows into a sparse ds-array of shape
        ``(n_rows, m)``; each row's capacity is padded to the target with
        zero data and sentinel indices (sortedness and the pad invariant
        hold)."""
        from repro_torch.core.dsarray import PAD_ZERO, DsArray
        if not self._data:
            raise ValueError("no block rows appended")
        target = self.nse if self.nse is not None else \
            max(1, max(d.shape[1] for d in self._data))
        sentinel = torch.tensor([self.bn, self.bm], dtype=torch.int32,
                                device=self.device)
        data_rows, index_rows = [], []
        for d, ix in zip(self._data, self._indices):
            pad = target - d.shape[1]
            if pad:
                d = torch.cat([d, d.new_zeros((self.gm, pad))], dim=1)
                ix = torch.cat([ix, sentinel.expand(self.gm, pad, 2)], dim=1)
            data_rows.append(d)
            index_rows.append(ix)
        grid = BlockGrid((self.n_rows, self.m), (self.bn, self.bm))
        if grid.stacked_shape[0] != len(data_rows):
            raise ValueError(
                f"appended {len(data_rows)} block rows but {self.n_rows} "
                f"logical rows need {grid.stacked_shape[0]}")
        blocks = StackedCOO(torch.stack(data_rows), torch.stack(index_rows),
                            (len(data_rows), self.gm, self.bn, self.bm),
                            indices_sorted=True, unique_indices=True)
        return DsArray(blocks, grid, PAD_ZERO)


def fetch_row_dense(a: "DsArray", i: int) -> torch.Tensor:
    """Row ``i`` of a sparse ds-array as a padded dense ``(gm*bm,)`` vector,
    from block row ``i // bn`` only (the k-means++ seeding fetch).  The
    block row is merged first, so each output position receives at most
    one nonzero term."""
    gn, gm, bn, bm = a.blocks.shape
    gi, off = int(i) // bn, int(i) % bn
    sp = a.blocks
    row = _canon_unique(StackedCOO(sp.data[gi:gi + 1], sp.indices[gi:gi + 1],
                                   (1, gm, bn, bm), sp.indices_sorted,
                                   sp.unique_indices))
    idx = row.indices[0].long()                    # (gm, nse, 2)
    col = (torch.arange(gm, device=sp.device)[:, None] * bm
           + idx[..., 1].clamp(max=bm - 1))
    hit = (idx[..., 0] == off) & (idx[..., 1] < bm)
    vals = torch.where(hit, row.data[0], torch.zeros((), dtype=row.dtype,
                                                     device=row.device))
    out = torch.zeros(gm * bm, dtype=row.dtype, device=row.device)
    return out.index_add_(0, col.reshape(-1), vals.reshape(-1))


# ---------------------------------------------------------------------------
# Elementwise dispatch (shared by the eager ops and the lazy recorder)
# ---------------------------------------------------------------------------


def _probe_zero(op: Callable, rhs, reverse: bool, dtype) -> bool:
    """True iff ``op`` maps an implicit zero (paired with the known scalar
    ``rhs``) back to zero: the gate for index-preserving data maps."""
    try:
        z = torch.zeros((), dtype=dtype)
        if isinstance(rhs, torch.Tensor):
            rhs = rhs.detach().cpu()
        out = op(rhs, z) if reverse else op(z, rhs)
        return bool(out == 0)
    except _RECOVERABLE:
        return False


_PAIR_NATIVE = {"add", "sub", "mul"}
_GATHER_NATIVE = {"mul", "true_divide"}


def classify_binary(op: Callable, lhs_sparse: bool, rhs, reverse: bool,
                    lhs_dtype) -> str:
    """How to run ``op(lhs, rhs)`` with at least one sparse operand.

    ``rhs`` is ``("ds", is_sparse, dtype)`` or a raw scalar.  Returns
    ``"data"`` (index-preserving map of the sparse data: scalar other,
    ``op(0, s) == 0``), ``"pair"`` (both sparse: add/sub/mul), ``"gather"``
    (sparse x dense mul, or div with the sparse side on top) or ``"dense"``
    (no zero-preserving sparse form: densify first)."""
    name = getattr(op, "__name__", "")
    if isinstance(rhs, tuple):
        _, rhs_sparse, _ = rhs
        if lhs_sparse and rhs_sparse:
            return "pair" if name in _PAIR_NATIVE else "dense"
        if not (lhs_sparse or rhs_sparse):
            # alignment densified the sparse operand (a rechunk): nothing
            # sparse is left for the gather to index
            return "dense"
        # the gather form needs op(0, y) == 0 for EVERY y: mul, and div
        # with the sparse side as the numerator
        sparse_on_top = lhs_sparse != reverse
        if name in _GATHER_NATIVE and (name == "mul" or sparse_on_top):
            return "gather"
        return "dense"
    return "data" if (lhs_sparse and _probe_zero(op, rhs, reverse, lhs_dtype)) \
        else "dense"


def data_map_fn(op: Callable, scalar, reverse: bool) -> Callable:
    """blocks -> blocks closure of a scalar data map (eager and lazy)."""
    linear = getattr(op, "__name__", "") in _LINEAR_DATA_OPS

    def fn(sp: StackedCOO) -> StackedCOO:
        if not linear:
            sp = _canon_unique(sp)
        out = op(scalar, sp.data) if reverse else op(sp.data, scalar)
        return _rebuild(sp, out)
    return fn


def _pair_mul(a: StackedCOO, b: StackedCOO) -> StackedCOO:
    """``a * b`` over the positions both store: the canonical index list of
    the operand with fewer slots searched, block by block, in the other's,
    so the capacity is ``min(nse_a, nse_b)`` (the reference sizes it at
    ``nse_a · nse_b``).  The values are the products of the merged entries,
    ``(a1 + a2)(b1 + b2)``; positions only one side stores keep zero data."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    small, large = (a, b) if a.nse <= b.nse else (b, a)
    if _is_meta(a) or _is_meta(b) or small.nse == 0:
        return _empty_like(small, small.nse, dtype)
    if a is b:                                    # x * x: every position
        s = _canon_unique(a)
        return _rebuild(s, s.data.to(dtype) * s.data.to(dtype))
    small, large = _canonical(small), _canonical(large)
    gn, gm, bn, bm = a.shape
    out = []
    for gi in range(gn):
        ks = _block_keys(small, gi)               # (gm, nse_s)
        kl = _block_keys(large, gi)               # (gm, nse_l), sorted
        pos = torch.searchsorted(kl, ks).clamp(max=large.nse - 1)
        hit = (kl.gather(1, pos) == ks) & (ks < bn * bm)
        prod = small.data[gi].to(dtype) * large.data[gi].gather(1, pos).to(dtype)
        out.append(torch.where(hit, prod, torch.zeros((), dtype=dtype,
                                                      device=prod.device)))
    return _rebuild(small, torch.stack(out))


def _block_keys(sp: StackedCOO, gi: int) -> torch.Tensor:
    """(gm, nse) int64 linear keys of block row ``gi``; sentinels map to
    ``bn*bm``, above every in-bounds key."""
    bn, bm = sp.shape[2:]
    idx = sp.indices[gi].long()
    return torch.where((idx[..., 0] < bn) & (idx[..., 1] < bm),
                       idx[..., 0] * bm + idx[..., 1], bn * bm)


def pair_fn(op: Callable, reverse: bool) -> Callable:
    """blocks -> blocks closure of sparse (+|-|*) sparse."""
    name = getattr(op, "__name__", "")

    def fn(x: StackedCOO, y: StackedCOO) -> StackedCOO:
        a, b = (y, x) if reverse else (x, y)
        if name == "mul":
            return _pair_mul(a, b)
        dtype = torch.promote_types(a.dtype, b.dtype)
        bd = b.data.to(dtype)
        data = torch.cat([a.data.to(dtype), bd if name == "add" else -bd], dim=2)
        return StackedCOO(data, torch.cat([a.indices, b.indices], dim=2),
                          a.shape, False, False)
    return fn


def gather_fn(op: Callable, sparse_left: bool) -> Callable:
    """blocks -> blocks closure of sparse x dense mul/div: the dense operand
    is read at the sparse operand's stored indices, so the result keeps the
    index structure."""
    def fn(x, y):
        sp, dn = (x, y) if sparse_left else (y, x)
        vals = _gather_dense_at(sp, dn)
        out = op(sp.data, vals) if sparse_left else op(vals, sp.data)
        # zero-data slots (sentinels, grid growth) stay EXACTLY zero: 0/0 at
        # a dirty dense pad position would smuggle a nan into the pad
        out = torch.where(sp.data == 0, torch.zeros((), dtype=out.dtype,
                                                    device=out.device), out)
        return _rebuild(sp, out)
    return fn


def binary(a: "DsArray", other, op: Callable, reverse: bool):
    """Eager sparse-aware ``_binary``: operands are aligned as on the dense
    path, then dispatched per :func:`classify_binary`.  Returns
    NotImplemented for operand types the dense path also rejects."""
    from repro_torch.core.dsarray import PAD_ZERO, DsArray, _scalar_operand
    me = a
    if isinstance(other, DsArray):
        if other.shape != me.shape:
            raise ValueError(f"shape mismatch {me.shape} vs {other.shape}")
        if other.block_shape != me.block_shape:
            other = other.rechunk(me.block_shape)      # densifies a sparse rhs
        if other.stacked_grid != me.stacked_grid:
            common = (max(me.stacked_grid[0], other.stacked_grid[0]),
                      max(me.stacked_grid[1], other.stacked_grid[1]))
            me, other = me._pad_grid_to(common), other._pad_grid_to(common)
        rhs_desc = ("ds", other.block_format == FORMAT_BCOO, other.dtype)
    else:
        other = _scalar_operand(other)
        if other is None:
            return NotImplemented
        rhs_desc = other

    mode = classify_binary(op, me.block_format == FORMAT_BCOO, rhs_desc,
                           reverse, me.dtype)
    if mode == "data":
        return DsArray(data_map_fn(op, other, reverse)(me.blocks), me.grid,
                       PAD_ZERO)
    if mode == "pair":
        return DsArray(pair_fn(op, reverse)(me.blocks, other.blocks),
                       me.grid, PAD_ZERO)
    if mode == "gather":
        lhs_sp = me.block_format == FORMAT_BCOO
        out = gather_fn(op if not reverse else (lambda u, v: op(v, u)),
                        lhs_sp)(me.blocks, other.blocks)
        return DsArray(out, me.grid, PAD_ZERO)
    # densify whichever operands are sparse and take the dense path
    me = todense(me)
    if isinstance(other, DsArray):
        other = todense(other)
    return me._binary(other, op, reverse)


def zero_preserving_map(fn: Callable, dtype) -> bool:
    """``fn`` run on a zero (1, 1, 1, 1) block keeps the shape and gives
    zero: eligible for the index-preserving data map."""
    try:
        out = fn(torch.zeros((1, 1, 1, 1), dtype=dtype))
        return (isinstance(out, torch.Tensor)
                and tuple(out.shape) == (1, 1, 1, 1) and bool(out.item() == 0))
    except _RECOVERABLE:
        return False


def map_blocks_sparse(a: "DsArray", fn: Callable, pad) -> "DsArray":
    """``map_blocks`` over a sparse ds-array: a zero-preserving elementwise
    ``fn`` runs on the data, viewed as rank-4 ``(gn, gm, nse, 1)``;
    anything else (``fn(0) != 0``, an explicit ``pad``) densifies."""
    from repro_torch.core.dsarray import PAD_ZERO, DsArray
    if pad is not None or not zero_preserving_map(fn, a.dtype):
        return todense(a).map_blocks(fn, pad=pad)
    return DsArray(sparse_map_fn(fn)(a.blocks), a.grid, PAD_ZERO)


def sparse_map_fn(fn: Callable) -> Callable:
    """blocks -> blocks closure of the data map above (for the lazy layer).
    User fns are nonlinear until proven otherwise: merge split entries."""
    def mapped(sp: StackedCOO) -> StackedCOO:
        sp = _canon_unique(sp)
        return _rebuild(sp, fn(sp.data[..., None])[..., 0])
    return mapped


# ---------------------------------------------------------------------------
# Structure ops (sparse-native)
# ---------------------------------------------------------------------------


def aligned_slice_sparse(a: "DsArray", rows: slice, cols: slice) -> "DsArray":
    """Block-aligned slice (start on a block boundary, unit step) of a
    sparse ds-array: a batch-dim slice of ``data``/``indices``, never a
    densify.  A slice that stops mid-block keeps the slots and zeroes the
    data of entries past the new logical edge, so the result owns no entry
    in its pad region."""
    from repro_torch.core.blocking import grid_span
    from repro_torch.core.dsarray import PAD_ZERO, DsArray
    sp = a.blocks
    gn, gm, bn, bm = sp.shape
    n, m = a.shape
    r0, r1, rs = rows.indices(n)
    c0, c1, cs = cols.indices(m)
    if rs != 1 or cs != 1 or r0 % bn or c0 % bm:
        raise ValueError(f"not a block-aligned unit-step slice: {rows}, {cols}")
    g0, g1 = (0, 1) if r1 <= r0 else grid_span(r0, r1, bn)
    h0, h1 = (0, 1) if c1 <= c0 else grid_span(c0, c1, bm)
    data = sp.data[g0:g1, h0:h1]
    indices = sp.indices[g0:g1, h0:h1]
    nr, nc = max(0, r1 - r0), max(0, c1 - c0)
    if (g1 - g0) * bn > nr or (h1 - h0) * bm > nc:
        bi = torch.arange(g1 - g0, device=sp.device)[:, None, None]
        bj = torch.arange(h1 - h0, device=sp.device)[None, :, None]
        valid = ((bi * bn + indices[..., 0]) < nr) & \
                ((bj * bm + indices[..., 1]) < nc)
        data = torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                                    device=data.device))
    blocks = StackedCOO(data, indices, (g1 - g0, h1 - h0, bn, bm),
                        sp.indices_sorted, sp.unique_indices)
    return DsArray(blocks, BlockGrid((nr, nc), (bn, bm)), PAD_ZERO)


def rows_to_dense(a: "DsArray") -> torch.Tensor:
    """All rows of a (small) sparse ds-array as one dense ``(n, m)`` tensor
    on its device, the merged entries written straight into row-major
    layout (no stacked dense tensor); a dense input takes ``collect``."""
    if a.block_format != FORMAT_BCOO:
        return a.collect()
    sp = _canon_unique(a.blocks)
    gn, gm, bn, bm = sp.shape
    n, m = a.shape
    idx = sp.indices.long()
    rr = torch.arange(gn, device=sp.device)[:, None, None] * bn + idx[..., 0]
    cc = torch.arange(gm, device=sp.device)[None, :, None] * bm + idx[..., 1]
    ok = _valid(sp)
    out = torch.zeros((gn * bn, gm * bm), dtype=sp.dtype, device=sp.device)
    out[rr[ok], cc[ok]] = sp.data[ok]
    return out[:n, :m]


def astype_sparse(a: "DsArray", dtype) -> "DsArray":
    """Cast the data; split entries merge first, since a narrowing cast of
    the sum differs from the sum of the casts."""
    from repro_torch.core.dsarray import PAD_ZERO, DsArray, _cast
    sp = _canon_unique(a.blocks)
    return DsArray(_rebuild(sp, _cast(sp.data, dtype)), a.grid, PAD_ZERO)


def transpose_sparse(a: "DsArray") -> "DsArray":
    """Batch-dim swap + per-entry index swap: O(nnz), no dense relayout."""
    from repro_torch.core.dsarray import PAD_ZERO, DsArray
    sp = a.blocks
    gn, gm, bn, bm = sp.shape
    blocks = StackedCOO(sp.data.permute(1, 0, 2),
                        sp.indices.permute(1, 0, 2, 3).flip(-1),
                        (gm, gn, bm, bn), False, sp.unique_indices)
    return DsArray(blocks, a.grid.transpose(), PAD_ZERO)


def pad_grid_sparse(a: "DsArray", stacked_grid: Tuple[int, int]) -> "DsArray":
    """Grow the stacked grid: the new blocks hold sentinel slots only."""
    from repro_torch.core.dsarray import PAD_ZERO, DsArray
    gn, gm = a.stacked_grid
    tn, tm = stacked_grid
    if (tn, tm) == (gn, gm):
        return a
    if tn < gn or tm < gm:
        raise ValueError("can only grow the stacked grid")
    sp = a.blocks
    bn, bm = sp.shape[2:]
    data = sp.data.new_zeros((tn, tm, sp.nse))
    data[:gn, :gm] = sp.data
    indices = torch.tensor([bn, bm], dtype=torch.int32, device=sp.device).repeat(
        tn, tm, sp.nse, 1)
    indices[:gn, :gm] = sp.indices
    blocks = StackedCOO(data, indices, (tn, tm, bn, bm), sp.indices_sorted,
                        sp.unique_indices)
    return DsArray(blocks, a.grid, PAD_ZERO)


def place_sparse(a: "DsArray", mesh, places) -> "DsArray":
    """``a``'s stacked COO with ``data`` and ``indices`` placed on ``mesh``
    with the grid-dim placements ``places`` (each rank keeps its blocks'
    entries whole)."""
    from repro_torch.core import placement as pl
    from repro_torch.core.dsarray import DsArray
    sp = a.blocks
    blocks = StackedCOO(pl.place(sp.data, mesh, places),
                        pl.place(sp.indices, mesh, places), sp.shape,
                        sp.indices_sorted, sp.unique_indices)
    return DsArray(blocks, a.grid, a.pad_state)


def distribute_sparse(a: "DsArray", mesh, axes) -> "DsArray":
    """Shard a sparse ds-array's grid dims over the mesh: the grid padded
    to mesh multiples (sentinel blocks), then ``data (gn, gm, nse)`` and
    ``indices (gn, gm, nse, 2)`` placed with matching placements.  Only
    ``collect``/``todense`` (and ``distribute``) read it in place; every
    other op runs on the gathered blocks (``core.dsarray``)."""
    from repro_torch.core import placement as pl
    from repro_torch.core.blocking import round_up
    places = pl.placements(mesh, axes)
    gn, gm = a.stacked_grid
    target = (round_up(gn, pl.axis_size(mesh, axes[0])),
              round_up(gm, pl.axis_size(mesh, axes[1])))
    if a.is_distributed:
        data = a.blocks.data
        if (data.device_mesh == mesh and target == (gn, gm)
                and tuple(data.placements) == places):
            return a
        a = gather_sparse(a)
    return place_sparse(pad_grid_sparse(a, target), mesh, places)


def gather_sparse(a: "DsArray") -> "DsArray":
    """A distributed sparse ds-array with every block on this rank."""
    from repro_torch.core import placement as pl
    from repro_torch.core.dsarray import DsArray
    sp = a.blocks
    blocks = StackedCOO(pl.gather(sp.data), pl.gather(sp.indices), sp.shape,
                        sp.indices_sorted, sp.unique_indices)
    return DsArray(blocks, a.grid, a.pad_state)


def reduce_sparse(a: "DsArray", op: str, axis: Optional[int]):
    """Reductions over a sparse ds-array.  ``sum`` is sparse-native: the
    stored entries are summed (implicit zeros are the identity), per row or
    column as the product with a ones vector through
    ``kernels.matmul.ops.sparse_contract``; only the small result is dense.
    ``max``/``min`` rank stored entries against the implicit zeros, so they
    densify."""
    from repro_torch.core.dsarray import DsArray, pad_state_of
    from repro_torch.kernels.matmul.ops import sparse_contract
    if op != "sum":
        return todense(a)._reduce(op, axis)
    sp = a.blocks
    gn, gm, bn, bm = sp.shape
    if axis is None:
        return sp.data.sum(dtype=sp.dtype)
    if axis == 0:
        ones = torch.ones((gn, 1, bn, 1), dtype=sp.dtype, device=sp.device)
        out = sparse_contract(sp, ones, out_dtype=sp.dtype, transpose_a=True)
        blocks = out.reshape(1, gm, 1, bm)                 # (gm, 1, bm, 1)
        grid = BlockGrid((1, a.shape[1]), (1, bm))
    elif axis == 1:
        ones = torch.ones((gm, 1, bm, 1), dtype=sp.dtype, device=sp.device)
        blocks = sparse_contract(sp, ones, out_dtype=sp.dtype,
                                 transpose_a=False)        # (gn, 1, bn, 1)
        grid = BlockGrid((a.shape[0], 1), (bn, 1))
    else:
        raise ValueError(f"axis must be 0, 1 or None, got {axis}")
    return DsArray(blocks, grid, pad_state_of(0))


# ---------------------------------------------------------------------------
# Invariant checking
# ---------------------------------------------------------------------------


def check_bcoo_invariants(a: "DsArray") -> None:
    """Raise if the storage breaks the sparse ds-array contract: indices
    non-negative; every out-of-bounds slot holds zero data (the sentinel);
    every in-bounds entry at a logical-pad position holds zero data (sparse
    arrays are zero-padded by construction)."""
    sp = a.blocks
    if not isinstance(sp, StackedCOO):
        raise AssertionError(f"sparse blocks must be a StackedCOO, got "
                             f"{type(sp).__name__}")
    if a.pad_state.kind != "zero":
        raise AssertionError(
            f"sparse ds-arrays are zero-padded by construction, "
            f"claimed {a.pad_state}")
    idx = sp.indices.detach().cpu().numpy()
    data = sp.data.detach().cpu()
    data = (data.float() if data.dtype == torch.bfloat16 else data).numpy()
    gn, gm, bn, bm = sp.shape
    n, m = a.shape

    def _site(mask) -> str:
        gi, gj, slot = (int(v) for v in np.argwhere(mask)[0])
        return (f"{int(mask.sum())} violation(s), first in block "
                f"({gi}, {gj}) slot {slot}: index "
                f"({int(idx[gi, gj, slot, 0])}, {int(idx[gi, gj, slot, 1])})"
                f", data {data[gi, gj, slot]!r}")

    neg = (idx[..., 0] < 0) | (idx[..., 1] < 0)
    if np.any(neg):
        raise AssertionError(f"negative sparse index: {_site(neg)}")
    oob = (idx[..., 0] >= bn) | (idx[..., 1] >= bm)
    bad = oob & (data != 0)
    if np.any(bad):
        raise AssertionError(
            f"out-of-bounds sparse slot with nonzero data: {_site(bad)}")
    bi = np.arange(gn)[:, None, None]
    bj = np.arange(gm)[None, :, None]
    in_pad = ((bi * bn + idx[..., 0]) >= n) | ((bj * bm + idx[..., 1]) >= m)
    bad = in_pad & ~oob & (data != 0)
    if np.any(bad):
        raise AssertionError(
            "nonzero sparse entry in the logical pad region "
            f"(sparse pad invariant violated): {_site(bad)}")
