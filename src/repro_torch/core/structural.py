"""Block-native structural ops for ds-arrays (slice / filter / rechunk /
concat / gram).

The port of ``repro.core.structural``.  Every op consumes and produces the
``(gn, gm, bn, bm)`` stacked block tensor, never the ``(n, m)`` global
layout, and re-establishes the pad-is-zero invariant before returning.
Sparse operands densify first (per-position data movement has no form over
stored entries), except for the block-aligned slice, which slices the
stacked COO's grid dims, and ``gram``, which contracts the stored entries.

On a distributed operand (``DsArray.distribute``) each op runs on the
gathered blocks and its result is placed on the operand's mesh and axes,
its grid padded to the mesh's multiples (``concat_rows``: those of its
first distributed part; ``gram`` returns a tensor on every rank).  The
reference keeps the operand's ``NamedSharding`` the same way, and drops
to an unsharded result where the new grid does not divide the mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.blocking import (BlockGrid, can_regroup, ceil_div,
                                       grid_span, is_aligned_slice)
from repro_torch.core.dsarray import _gathers, _replace


def _as_dense(a):
    """``a`` with dense blocks: the structural ops densify a sparse operand
    by policy (the ``core.dsarray`` op table)."""
    return a.todense() if a.is_sparse else a


def _mask_axes(blocks: torch.Tensor, n: Optional[int] = None,
               m: Optional[int] = None) -> torch.Tensor:
    """Zero the pad region beyond row ``n`` and/or column ``m`` (``None``
    skips that axis) with one ``where`` over per-axis masks."""
    from repro_torch.core.dsarray import _axis_mask
    gn, gm, bn, bm = blocks.shape
    mask = None
    if n is not None:
        mask = _axis_mask(n, gn, bn, blocks.device)[:, None, :, None]
    if m is not None:
        cm = _axis_mask(m, gm, bm, blocks.device)[None, :, None, :]
        mask = cm if mask is None else (mask & cm)
    if mask is None:
        return blocks
    return torch.where(mask, blocks, torch.zeros((), dtype=blocks.dtype,
                                                 device=blocks.device))


# ---------------------------------------------------------------------------
# Row/col gathers (the per-block lowering for unaligned selection)
# ---------------------------------------------------------------------------


def _gather_block_rows(blocks: torch.Tensor, idx: torch.Tensor,
                       out_bn: int) -> torch.Tensor:
    """Select global rows ``idx`` from a stacked tensor as ONE gather.

    Source row ``s`` lives at ``blocks[s // bn, :, s % bn, :]``; the gather
    output is already in block-row-major order.  Returns
    ``(out_gn, gm, out_bn, bm)``; the caller re-masks.
    """
    gn, gm, bn, bm = blocks.shape
    p = idx.shape[0]
    out_gn = max(1, ceil_div(p, out_bn))
    pad = out_gn * out_bn - p
    if pad:
        idx = torch.cat([idx, torch.zeros(pad, dtype=idx.dtype,
                                          device=idx.device)])
    rows = blocks[idx // bn, :, idx % bn, :]        # (out_gn*out_bn, gm, bm)
    return rows.reshape(out_gn, out_bn, gm, bm).permute(0, 2, 1, 3)


def as_index(k):
    """An integer index array from a list, array or tensor; a bool mask
    gives the positions of its True entries."""
    if isinstance(k, torch.Tensor):
        return torch.nonzero(k).reshape(-1) if k.dtype == torch.bool else k
    arr = np.asarray(k)
    return np.flatnonzero(arr) if arr.dtype == bool else arr


def index_vector(idx, size: int, device, what: str,
                 checked: bool = False) -> torch.Tensor:
    """A 1-D int64 index tensor on ``device`` with negatives wrapped and the
    range checked (a host sync for an index on the card).  ``checked=True``
    skips the range check, for an index that was made by this function
    already (a lazy plan checks its index once, when the op is recorded)."""
    t = idx if isinstance(idx, torch.Tensor) else torch.as_tensor(np.asarray(idx))
    if t.ndim != 1:
        raise IndexError(f"{what} index must be 1-D, got shape {tuple(t.shape)}")
    t = t.to(device=device, dtype=torch.int64)
    t = torch.where(t < 0, t + size, t)
    if not checked and t.numel() and (int(t.min()) < 0 or int(t.max()) >= size):
        raise IndexError(f"{what} index out of range for {size} {what}s")
    return t


@_gathers()
def take_rows(a, idx, out_bn: Optional[int] = None, checked: bool = False):
    """Integer-array row selection (the paper's 'filtering'), block-native.
    ``checked``: see :func:`index_vector`."""
    a = _as_dense(a).ensure_zero_pad()  # gathers re-use the source col pad
    n, m = a.shape
    idx = index_vector(idx, n, a.device, "row", checked)
    p = int(idx.shape[0])
    bn = a.block_shape[0]
    out_bn = out_bn or min(bn, max(1, p))
    out = _gather_block_rows(a.blocks, idx, out_bn)
    if out.shape[0] * out_bn > p:
        out = _mask_axes(out, n=p)
    grid = BlockGrid((p, m), (out_bn, a.block_shape[1]))
    return type(a)(out, grid)


@_gathers()
def take_cols(a, idx, out_bm: Optional[int] = None, checked: bool = False):
    """Column analogue of :func:`take_rows` (gather on the transposed grid)."""
    a = _as_dense(a).ensure_zero_pad()
    n, m = a.shape
    idx = index_vector(idx, m, a.device, "col", checked)
    p = int(idx.shape[0])
    bm = a.block_shape[1]
    out_bm = out_bm or min(bm, max(1, p))
    flipped = a.blocks.permute(1, 0, 3, 2)
    out = _gather_block_rows(flipped, idx, out_bm).permute(1, 0, 3, 2)
    if out.shape[1] * out_bm > p:
        out = _mask_axes(out, m=p)
    grid = BlockGrid((n, p), (a.block_shape[0], out_bm))
    return type(a)(out, grid)


# ---------------------------------------------------------------------------
# Aligned slicing: pure grid slice + edge remask
# ---------------------------------------------------------------------------


@_gathers()
def aligned_slice(a, rows: slice, cols: slice):
    """``A[r0:r1, c0:c1]`` with r0/c0 on block boundaries and unit step: a
    grid slice (a view) plus an edge remask when the slice stops mid-block."""
    a = _as_dense(a).ensure_zero_pad()
    n, m = a.shape
    bn, bm = a.block_shape
    r0, r1, rs = rows.indices(n)
    c0, c1, cs = cols.indices(m)
    if rs != 1 or cs != 1 or r0 % bn or c0 % bm:
        raise ValueError(f"not a block-aligned unit-step slice: {rows}, {cols}")
    g0, g1 = (0, 1) if r1 <= r0 else grid_span(r0, r1, bn)
    h0, h1 = (0, 1) if c1 <= c0 else grid_span(c0, c1, bm)
    out = a.blocks[g0:g1, h0:h1]
    nr, nc = max(0, r1 - r0), max(0, c1 - c0)
    # re-mask only when the slice STOPS mid-block before the end of the data
    need_r = nr if (r1 % bn != 0 and r1 < n) or nr == 0 else None
    need_c = nc if (c1 % bm != 0 and c1 < m) or nc == 0 else None
    out = _mask_axes(out, n=need_r, m=need_c)
    return type(a)(out, BlockGrid((nr, nc), (bn, bm)))


@_gathers()
def getitem(a, key, checked: bool = False):
    """NumPy-style ``A[key]`` lowered to block-native ops (paper §4.2.3).

    Aligned unit-step slices take the grid-slice path; everything else
    (unaligned starts, strides, negative steps, int arrays, bool masks)
    lowers to one gather per affected axis.  ``checked=True``: the index
    arrays in ``key`` were range-checked already (:func:`index_vector`).
    """
    if not isinstance(key, tuple):
        key = (key, slice(None))
    if len(key) != 2:
        raise IndexError("ds-arrays are 2-D")
    rows, cols = key

    def classify(k, size: int, block: int):
        """-> ("aligned", slice) | ("gather", idx)"""
        if isinstance(k, (int, np.integer)):
            k = int(k)
            if k < -size or k >= size:
                raise IndexError(f"index {k} out of range for size {size}")
            if k < 0:
                k += size
            if k % block == 0:
                return ("aligned", slice(k, k + 1))
            return ("gather", torch.tensor([k]))
        if isinstance(k, slice):
            if is_aligned_slice(k, size, block):
                return ("aligned", k)
            return ("gather", torch.arange(*k.indices(size)))
        return ("gather", as_index(k))

    rkind, rsel = classify(rows, a.shape[0], a.block_shape[0])
    ckind, csel = classify(cols, a.shape[1], a.block_shape[1])

    def is_full(kind, sel, size):
        return kind == "aligned" and sel.indices(size) == (0, size, 1)

    if a.is_sparse and rkind == "aligned" and ckind == "aligned":
        # a block-aligned selection of a sparse array slices the stacked
        # COO's grid dims: no densify
        if is_full(rkind, rsel, a.shape[0]) and is_full(ckind, csel, a.shape[1]):
            return a
        from repro_torch.core import sparse as sparse_mod
        return sparse_mod.aligned_slice_sparse(a, rsel, csel)

    out = a
    # grid slices first (cheapest: shrink before gathering)
    if ((rkind == "aligned" and not is_full(rkind, rsel, a.shape[0]))
            or (ckind == "aligned" and not is_full(ckind, csel, a.shape[1]))):
        out = aligned_slice(out,
                            rsel if rkind == "aligned" else slice(None),
                            csel if ckind == "aligned" else slice(None))
    if rkind == "gather":
        out = take_rows(out, rsel, checked=checked)
    if ckind == "gather":
        out = take_cols(out, csel, checked=checked)
    return out


# ---------------------------------------------------------------------------
# Rechunk: grid-local regroup when block shapes divide, gather repack else
# ---------------------------------------------------------------------------


def _pad_grid_axis(blocks: torch.Tensor, axis: int, pad: int) -> torch.Tensor:
    shape = list(blocks.shape)
    shape[axis] = pad
    return torch.cat([blocks, torch.zeros(shape, dtype=blocks.dtype,
                                          device=blocks.device)], dim=axis)


def _split_rows(blocks: torch.Tensor, new_bn: int) -> torch.Tensor:
    gn, gm, bn, bm = blocks.shape
    f = bn // new_bn
    out = blocks.reshape(gn, gm, f, new_bn, bm).permute(0, 2, 1, 3, 4)
    return out.reshape(gn * f, gm, new_bn, bm)


def _merge_rows(blocks: torch.Tensor, new_bn: int) -> torch.Tensor:
    gn, gm, bn, bm = blocks.shape
    f = new_bn // bn
    pad = (-gn) % f
    if pad:
        blocks = _pad_grid_axis(blocks, 0, pad)
    gn2 = (gn + pad) // f
    out = blocks.reshape(gn2, f, gm, bn, bm).permute(0, 2, 1, 3, 4)
    return out.reshape(gn2, gm, new_bn, bm)


def _regroup_rows(blocks: torch.Tensor, new_bn: int) -> torch.Tensor:
    bn = blocks.shape[2]
    if new_bn == bn:
        return blocks
    return _split_rows(blocks, new_bn) if bn % new_bn == 0 \
        else _merge_rows(blocks, new_bn)


def _split_cols(blocks: torch.Tensor, new_bm: int) -> torch.Tensor:
    gn, gm, bn, bm = blocks.shape
    f = bm // new_bm
    out = blocks.reshape(gn, gm, bn, f, new_bm).permute(0, 1, 3, 2, 4)
    return out.reshape(gn, gm * f, bn, new_bm)


def _merge_cols(blocks: torch.Tensor, new_bm: int) -> torch.Tensor:
    gn, gm, bn, bm = blocks.shape
    f = new_bm // bm
    pad = (-gm) % f
    if pad:
        blocks = _pad_grid_axis(blocks, 1, pad)
    gm2 = (gm + pad) // f
    out = blocks.reshape(gn, gm2, f, bn, bm).permute(0, 1, 3, 2, 4)
    return out.reshape(gn, gm2, bn, new_bm)


def _regroup_cols(blocks: torch.Tensor, new_bm: int) -> torch.Tensor:
    bm = blocks.shape[3]
    if new_bm == bm:
        return blocks
    return _split_cols(blocks, new_bm) if bm % new_bm == 0 \
        else _merge_cols(blocks, new_bm)


def _rechunk_blocks(blocks: torch.Tensor, shape: Tuple[int, int],
                    new_bs: Tuple[int, int]) -> torch.Tensor:
    """The regroup/repack math on the stacked tensor."""
    n, m = shape
    bn, bm = blocks.shape[2:]
    nbn, nbm = new_bs
    if can_regroup((bn, bm), new_bs):
        # regrouping preserves the padded-global coordinate of every element,
        # so the pad-is-zero invariant carries over — no remask needed
        return _regroup_cols(_regroup_rows(blocks, nbn), nbm)
    # windowed repack: one row gather + one col gather in block layout;
    # tiling pad slots replicate row/col 0 and must be re-masked
    need_r = need_c = None
    if nbn != bn:
        blocks = _gather_block_rows(
            blocks, torch.arange(max(1, n), device=blocks.device), nbn)
        need_r = n if blocks.shape[0] * nbn > n else None
    if nbm != bm:
        flipped = blocks.permute(1, 0, 3, 2)
        blocks = _gather_block_rows(
            flipped, torch.arange(max(1, m), device=blocks.device), nbm
        ).permute(1, 0, 3, 2)
        need_c = m if blocks.shape[1] * nbm > m else None
    return _mask_axes(blocks, n=need_r, m=need_c)


@_gathers()
def rechunk(a, block_shape: Tuple[int, int]):
    """Re-block to a new block size without materializing the global array:
    a reshape regroup when block shapes divide per axis, a windowed per-block
    gather otherwise."""
    block_shape = (int(block_shape[0]), int(block_shape[1]))
    if block_shape == a.block_shape:
        return a
    a = _as_dense(a).ensure_zero_pad()
    grid = BlockGrid(a.shape, block_shape)   # validates block_shape > 0
    return type(a)(_rechunk_blocks(a.blocks, a.shape, block_shape), grid)


# ---------------------------------------------------------------------------
# Concatenation
# ---------------------------------------------------------------------------


def concat_rows(arrays: Sequence):
    """Vertical concat, block-native.

    When every part but the last (after rechunking to the first part's
    block shape) has a row count divisible by ``bn``, the result is a stack
    of the parts' block grids: no element is re-addressed.  Otherwise each
    part's valid rows are gathered in block layout and re-tiled.
    """
    arrays = list(arrays)
    if not arrays:
        raise ValueError("concat_rows of empty sequence")
    placed = [a for a in arrays if a.is_distributed]
    if placed:
        return _replace(concat_rows([a._gathered() for a in arrays]), placed[0])
    m = arrays[0].shape[1]
    for a in arrays[1:]:
        if a.shape[1] != m:
            raise ValueError(
                f"concat_rows column mismatch: {a.shape[1]} != {m}")
    bs = arrays[0].block_shape
    parts = [_as_dense(rechunk(a, bs)).ensure_zero_pad() for a in arrays]
    parts = [p for p in parts if p.shape[0] > 0] or parts[:1]
    bn, bm = bs
    total = sum(p.shape[0] for p in parts)
    gm = max(1, ceil_div(m, bm))

    def trimmed(p) -> torch.Tensor:
        """The valid grid rows only, the stacked gm cut to the logical one."""
        return p.blocks[: max(1, ceil_div(p.shape[0], bn)), :gm]

    if all(p.shape[0] % bn == 0 for p in parts[:-1]):
        # interior parts give whole blocks only and the last keeps its own
        # (zero) pad: the pad-is-zero invariant holds for the stack
        blocks = torch.cat([trimmed(p) for p in parts], dim=0)
    else:
        rows = []
        for p in parts:
            idx = torch.arange(p.shape[0], device=p.device)
            rows.append(trimmed(p)[idx // bn, :, idx % bn, :])   # (n_i, gm, bm)
        flat = torch.cat(rows, dim=0)
        out_gn = max(1, ceil_div(total, bn))
        pad = out_gn * bn - total
        if pad:
            flat = torch.cat([flat, flat.new_zeros((pad, gm, bm))], dim=0)
        blocks = flat.reshape(out_gn, bn, gm, bm).permute(0, 2, 1, 3)
    return type(arrays[0])(blocks, BlockGrid((total, m), bs))


# ---------------------------------------------------------------------------
# Block-native Gram matrix
# ---------------------------------------------------------------------------


def gram(a) -> torch.Tensor:
    """``AᵀA`` as a dense ``(m, m)`` tensor, computed per block: one einsum
    over the stacked tensor with fp32 accumulation (outside any kernel, as
    the reference leaves it), never the ``(n, m)`` global layout.  A sparse
    ``a`` is the left operand of ``matmul_ta`` with its dense form on the
    right: the stored entries are contracted, ``a`` itself never
    densifies."""
    a = a._gathered()
    if a.is_sparse:
        from repro_torch.core.dsarray import matmul_ta
        return matmul_ta(a, a.todense()).collect().to(a.dtype)
    b = a.ensure_zero_pad().blocks  # zero pad contributes nothing
    acc = torch.promote_types(b.dtype, torch.float32) \
        if b.dtype.is_floating_point else b.dtype
    bf = b.to(acc)
    g = torch.einsum("ijab,ikac->jbkc", bf, bf)
    gm, bm = b.shape[1], b.shape[3]
    m = a.shape[1]
    return g.reshape(gm * bm, gm * bm)[:m, :m].to(a.dtype)
