"""Public GEMM entry points: the stacked ``local_matmul`` under every ds-array
``@`` and ``matmul_ta``, and the 2-D ``matmul``.

A CUDA tensor of f32/bf16/f16 launches the CUDA kernel
(``kernel.stacked_matmul``); a CPU tensor takes the plain version
(``ref.stacked_matmul_ref``); a CUDA tensor of any other dtype raises.  A
``meta`` tensor (the lazy layer infers shapes on them) gets an empty
``meta`` result of the product's shape and dtype.

A sparse A (``core.sparse.StackedCOO``) takes :func:`sparse_contract`
instead, on any device: torch ops over the stored entries, never a densify
of A (a sparse B densifies).  ``gemm.dispatch_cuda`` /
``gemm.dispatch_plain`` / ``gemm.dispatch_sparse`` count the decisions.
"""

from __future__ import annotations

import torch

from repro_torch.core.sparse import StackedCOO, _acc_dtype, _to_dense_blocks
from repro_torch.kernels.matmul import kernel
from repro_torch.kernels.matmul.ref import matmul_ref, stacked_matmul_ref
from repro_torch.obs import metrics as _metrics

__all__ = ["local_matmul", "matmul", "sparse_contract", "stacked_matmul_ref",
           "matmul_ref"]

_DISPATCHES = _metrics.CounterGroup(
    "gemm", ("dispatch_cuda", "dispatch_plain", "dispatch_sparse"))

# the product rows one chunk of stored entries may gather at once, as a
# share of the sparse operand's stored bytes (floored at 1 MiB): what keeps
# a product's added memory well below the operand's own size
_CHUNK_SHARE = 16
_CHUNK_FLOOR = 1 << 20


def sparse_contract(a: StackedCOO, b: torch.Tensor, *, out_dtype,
                    transpose_a: bool = False) -> torch.Tensor:
    """The stacked product ``A @ B`` (or ``Aᵀ @ B``) of a sparse A, as
    ``local_matmul`` shapes it: A ``(gi, gk, bn, bk)`` (transposed:
    ``(gk, gi, bk, bn)``), B dense ``(gk, gj, bk, bm)``, out
    ``(gi, gj, bn, bm)``.

    Block by block of A, its in-bounds entries are put in order of their
    output row (the row of A, or its column for ``Aᵀ``; a stable sort unless
    the rows are sorted already), and in chunks of at most
    ``stored bytes / 16`` of gathered B rows: each entry's row of B (all
    ``gj·bm`` output columns) is gathered and scaled by the entry, and
    ``torch.segment_reduce`` sums each output row's run of entries in
    stored order; the chunks and the grid-k blocks add into the output in
    order.  No float atomics: the same call gives the same bits.  Sums run
    in float32 (float64 for 64-bit floats, integers and bool).  A is never
    densified, and the memory a product adds is the output plus one chunk.
    """
    if transpose_a:
        gk, gi, bk, bn = a.shape
    else:
        gi, gk, bn, bk = a.shape
    gk2, gj, bk2, bm = b.shape
    if gk != gk2 or bk != bk2:
        raise ValueError(f"sparse_contract inner mismatch {a.shape} x "
                         f"{tuple(b.shape)}")
    if a.device.type == "meta" or b.device.type == "meta":
        return torch.empty((gi, gj, bn, bm), dtype=out_dtype, device="meta")
    dev = a.device
    acc = _acc_dtype(a.dtype, b.dtype)
    width = gj * bm
    rows_b = b.permute(0, 2, 1, 3).reshape(gk, bk, width).to(acc)
    out = torch.zeros((gi, bn, width), dtype=acc, device=dev)
    stored = a.data.numel() * a.data.element_size() + a.indices.numel() * 4
    chunk = max(1, max(_CHUNK_FLOOR, stored // _CHUNK_SHARE)
                // (max(1, width) * out.element_size()))
    # the in-bounds entries of every block, counted once (one host sync):
    # ordered by output row they come first, so each block is cut to them
    # and the sentinel slots never reach a reduction
    rows_ok = (a.shape[2], a.shape[3])
    n_valid = torch.stack([((blk[..., 0] < rows_ok[0]) & (blk[..., 1] < rows_ok[1])
                            ).sum(-1) for blk in a.indices]).tolist()
    bounds = torch.arange(bn + 1, dtype=torch.int32, device=dev)
    seg_col, con_col = (1, 0) if transpose_a else (0, 1)
    sorted_rows = a.indices_sorted and not transpose_a
    for i in range(gi):
        for k in range(gk):
            blk = (k, i) if transpose_a else (i, k)
            nv = n_valid[blk[0]][blk[1]]
            if nv == 0:
                continue
            idx, data = a.indices[blk], a.data[blk]
            if sorted_rows:
                seg, con, data = idx[:nv, seg_col], idx[:nv, con_col], data[:nv]
            else:
                ok = (idx[:, 0] < rows_ok[0]) & (idx[:, 1] < rows_ok[1])
                seg, order = torch.sort(torch.where(ok, idx[:, seg_col], bn),
                                        stable=True)
                seg, order = seg[:nv], order[:nv]
                con, data = idx[order, con_col], data[order]
            for c0 in range(0, nv, chunk):
                s = seg[c0:c0 + chunk].contiguous()
                prod = rows_b[k].index_select(0, con[c0:c0 + chunk])
                prod.mul_(data[c0:c0 + chunk, None].to(acc))
                out[i] += torch.segment_reduce(
                    prod, "sum", offsets=torch.searchsorted(s, bounds),
                    unsafe=True)
    out = out.reshape(gi, bn, gj, bm).permute(0, 2, 1, 3)
    return out.to(out_dtype).contiguous()


def local_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
                 transpose_a: bool = False) -> torch.Tensor:
    """Blocked local GEMM on stacked tiles: (gi,gk,bn,bk) x (gk,gj,bk,bm).

    ``transpose_a=True`` computes ``Aᵀ @ B`` with ``a`` in its untransposed
    stacked layout ``(gk, gi, bk, bn)``; the kernel reads it transposed.
    Operands of two different float types are cast to their common type
    first (the kernel takes one input type).
    """
    if transpose_a:
        gk, gi, bk, bn = a.shape
    else:
        gi, gk, bn, bk = a.shape
    gk2, gj, bk2, bm = b.shape
    if gk != gk2 or bk != bk2:
        raise ValueError(f"local_matmul inner mismatch {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    if isinstance(b, StackedCOO):
        b = _to_dense_blocks(b)         # x @ sp: the right operand densifies
    if isinstance(a, StackedCOO):
        if a.device.type != "meta":
            _DISPATCHES.inc("dispatch_sparse")
        return sparse_contract(a, b, out_dtype=out_dtype,
                               transpose_a=transpose_a)
    if a.device.type == "meta":
        # shapes only (the lazy layer's metadata inference): no data is
        # read, nothing is launched and no dispatch is counted
        return torch.empty((gi, gj, bn, bm), dtype=out_dtype, device="meta")
    if a.device.type == "cpu":
        _DISPATCHES.inc("dispatch_plain")
        return stacked_matmul_ref(a, b, out_dtype=out_dtype,
                                  transpose_a=transpose_a)
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM for device {a.device}")
    if a.dtype not in kernel.DTYPE_CODES or b.dtype not in kernel.DTYPE_CODES:
        raise TypeError(f"the CUDA GEMM takes f32/bf16/f16, got {a.dtype} x "
                        f"{b.dtype}")
    common = torch.promote_types(a.dtype, b.dtype)
    _DISPATCHES.inc("dispatch_cuda")
    return kernel.stacked_matmul(a.to(common), b.to(common),
                                 out_dtype=out_dtype, transpose_a=transpose_a)


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """2-D ``(m, k) @ (k, n)`` of any shape: the ``gi = gj = gk = 1`` case of
    the stacked GEMM (edges are masked in the kernel, so nothing is padded).
    Output dtype ``out_dtype`` or ``a.dtype``, as the reference."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"matmul shape mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    out = local_matmul(a.reshape(1, 1, m, k), b.reshape(1, 1, k, n),
                       out_dtype=out_dtype or a.dtype)
    return out[0, 0]
