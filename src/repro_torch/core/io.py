"""Parallel-creation / IO routines for ds-arrays (paper §4.2.2), the port of
``repro.core.io``.

On PyCOMPSs these spawn one load task per block row (files are parsed line
by line).  The streaming loaders (``load_txt_file``, ``load_svmlight_file``,
``load_npy_rows``) realise the paper's "no process ever holds the full
matrix" claim literally: the file is read in line-aligned byte ranges
(:mod:`repro_torch.core.readers`) or off a memory map, each range fills at
most one block row, and every completed block row is copied into memory
torch owns on ``device`` before the next is touched.  Peak HOST memory is
O(block row), not O(n·m) (``tests/test_torch_io.py`` holds the
reference's tracemalloc bound); a block row's NumPy buffer is never kept
alive by the tensor made from it.  On the card each block row gets a fresh
host buffer, copied with a blocking copy, so no buffer is reused while a
copy may still read it.  Assembly stacks the block rows on the device, so
for a moment the device holds the array twice.

Every loader takes ``device=`` (default ``"cuda"``) and narrows 64-bit
values to 32 bits, as ``from_array`` does.  Each fires the ``io_load``
fault-injection site on entry (``source=<loader>``) and the streaming ones
once per chunk or block row (``block_row=<i>``); assembly state lives in
locals, so an abort mid-stream leaves nothing behind.  Spans:
``ingest.load`` per load, ``ingest.chunk`` per parsed chunk.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._faults import fire as _fire
from repro_torch.core import costmodel, readers
from repro_torch.core.blocking import BlockGrid, ceil_div
from repro_torch.core.dsarray import (_NARROW, DsArray, from_array,
                                      resolve_device)
from repro_torch.obs import tracing as _tracing


def _torch_dtype(dtype) -> torch.dtype:
    """The 32-bit torch dtype a NumPy ``dtype`` lands as."""
    t = torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype
    return _NARROW.get(t, t)


def from_array_auto(arr, block_shape: Tuple[int, int],
                    block_format: str = "auto",
                    density_threshold: Optional[float] = None,
                    device="cuda") -> DsArray:
    """Block a local array, picking dense vs sparse storage by density.

    ``block_format``: ``"dense"`` | ``"bcoo"`` | ``"auto"``.  Auto measures
    nnz/size and converts when it is below ``density_threshold`` — default
    the cost model's storage-crossover density for the input's item size
    (below it the sparse value+index stream is smaller than the dense
    tensor).  Only ``"auto"`` pays the density scan.
    """
    if block_format not in ("auto", "dense", "bcoo"):
        raise ValueError(f"unknown block_format {block_format!r}")
    a = from_array(arr, block_shape, device=device)
    if block_format == "dense":
        return a
    if block_format == "bcoo":
        return a.tosparse()
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) \
        else np.asarray(arr).dtype.itemsize
    thr = density_threshold if density_threshold is not None else \
        costmodel.sparse_storage_crossover_density(itemsize)
    n, m = a.shape
    density = int(torch.count_nonzero(a.blocks)) / max(1, n * m)  # pad is 0
    return a.tosparse() if density < thr else a


# ---------------------------------------------------------------------------
# Streaming block-row assembly
# ---------------------------------------------------------------------------


def _blockrow_to_device(buf: np.ndarray, gm: int, bm: int,
                        device: torch.device) -> torch.Tensor:
    """(bn, gm*bm) host block-row buffer -> (gm, bn, bm) tensor on
    ``device``, in memory torch owns: a blocking copy, so the caller may
    drop or refill ``buf`` as soon as this returns."""
    bn = buf.shape[0]
    out = torch.empty((gm, bn, bm), dtype=_torch_dtype(buf.dtype),
                      device=device)
    out.copy_(torch.from_numpy(buf).reshape(bn, gm, bm).permute(1, 0, 2))
    return out


def _stack_blockrows(blockrows, n: int, m: int,
                     block_shape: Tuple[int, int]) -> DsArray:
    """Stack streamed (gm, bn, bm) block rows into a ds-array."""
    return DsArray(torch.stack(blockrows, dim=0),
                   BlockGrid((n, m), tuple(block_shape)))


def load_txt_file(path: str, block_shape: Tuple[int, int],
                  delimiter: str = ",", dtype=np.float32,
                  n_features: Optional[int] = None,
                  chunk_bytes: int = readers.DEFAULT_CHUNK_BYTES,
                  device="cuda") -> DsArray:
    """Streaming delimited-text loader (dislib ``load_txt_file`` surface).

    The file is consumed in line-aligned byte ranges; each parses into a
    ``(k, m)`` slab that fills the current ``(bn, gm*bm)`` block-row buffer.
    A full buffer is copied to ``device`` as one block row and a fresh zero
    buffer takes its place, so the final partial block row is zero-padded
    by construction (pad ZERO).  Peak host memory: one chunk + one parsed
    slab + ~2 block-row buffers.  Bit-equal to
    ``from_array(np.loadtxt(path), block_shape)``.
    """
    _fire("io_load", source="load_txt_file", path=path)
    dev = resolve_device(device)
    with _tracing.span("ingest.load", source="load_txt_file", path=path):
        bn, bm = int(block_shape[0]), int(block_shape[1])
        m = None if n_features is None else int(n_features)
        gm = buf = None
        fill = n = 0
        blockrows = []
        for chunk in readers.iter_line_chunks(path, chunk_bytes):
            _fire("io_load", source="load_txt_file", path=path,
                  block_row=len(blockrows))
            with _tracing.span("ingest.chunk", source="load_txt_file",
                               block_row=len(blockrows),
                               chunk_bytes=len(chunk)):
                arr = readers.parse_txt_chunk(chunk, delimiter, dtype)
                if arr is None:
                    continue
                if m is None:
                    m = arr.shape[1]
                if buf is None:
                    gm = max(1, ceil_div(m, bm))
                    buf = np.zeros((bn, gm * bm), dtype)
                if arr.shape[1] != m:
                    raise ValueError(
                        f"{path}: ragged row width {arr.shape[1]} "
                        f"(expected {m})")
                done = 0
                while done < arr.shape[0]:
                    take = min(bn - fill, arr.shape[0] - done)
                    buf[fill:fill + take, :m] = arr[done:done + take]
                    fill += take
                    done += take
                    n += take
                    if fill == bn:
                        blockrows.append(_blockrow_to_device(buf, gm, bm, dev))
                        buf = np.zeros((bn, gm * bm), dtype)
                        fill = 0
        if fill:
            blockrows.append(_blockrow_to_device(buf, gm, bm, dev))
        if not blockrows:
            raise ValueError(f"{path}: no data rows")
        return _stack_blockrows(blockrows, n, m, (bn, bm))


def load_svmlight_file(path: str, block_shape: Tuple[int, int],
                       n_features: int, store_sparse: bool = True,
                       dtype=np.float32, zero_based: bool = False,
                       nse: Optional[int] = None,
                       chunk_bytes: int = readers.DEFAULT_CHUNK_BYTES,
                       device="cuda") -> Tuple[DsArray, DsArray]:
    """Streaming svmlight/libsvm loader -> ``(x, y)`` (dislib surface).

    Each line-aligned chunk parses into COO triplets with chunk-local row
    ids; triplets route into the current block row and every completed
    block row is packed at once — sparse rows through
    :class:`repro_torch.core.sparse.StackedBCOOBuilder` (one stacked COO at
    a shared ``nse``, never densified), dense rows through a scatter into a
    ``(bn, gm*bm)`` buffer.  Labels assemble the same way into an (n, 1)
    dense ds-array with block shape ``(bn, 1)``.  Feature ids are 1-based
    unless ``zero_based=True``; an id outside ``[0, n_features)`` after the
    shift raises.  Peak host memory is O(block row); the sparse result is
    bit-equal to ``from_scipy`` of the same triplets (same default nse =
    the max block nnz).
    """
    _fire("io_load", source="load_svmlight_file", path=path)
    from repro_torch.core import sparse as sparse_mod
    dev = resolve_device(device)
    bn, bm = int(block_shape[0]), int(block_shape[1])
    n_features = int(n_features)
    gm = max(1, ceil_div(n_features, bm))
    builder = sparse_mod.StackedBCOOBuilder(
        n_features, (bn, bm), _torch_dtype(dtype), nse, device=dev) \
        if store_sparse else None
    xbuf = None if store_sparse else np.zeros((bn, gm * bm), dtype)
    pend = ([], [], [])                      # sparse: per-segment triplets
    ybuf = np.zeros((bn, 1), dtype)
    x_blockrows, y_blockrows = [], []
    fill = n = 0

    def _flush(k: int) -> None:
        nonlocal xbuf, ybuf, pend
        if store_sparse:
            parts = [np.concatenate(p) if p else np.empty(0, np.int64)
                     for p in pend[:2]]
            vparts = np.concatenate(pend[2]) if pend[2] else \
                np.empty(0, dtype)
            builder.append_blockrow(parts[0], parts[1], vparts, k)
            pend = ([], [], [])
        else:
            x_blockrows.append(_blockrow_to_device(xbuf, gm, bm, dev))
            xbuf = np.zeros((bn, gm * bm), dtype)
        y_blockrows.append(_blockrow_to_device(ybuf, 1, 1, dev))
        ybuf = np.zeros((bn, 1), dtype)

    with _tracing.span("ingest.load", source="load_svmlight_file",
                       path=path, sparse=store_sparse):
        for chunk in readers.iter_line_chunks(path, chunk_bytes):
            _fire("io_load", source="load_svmlight_file", path=path,
                  block_row=n // bn)
            with _tracing.span("ingest.chunk", source="load_svmlight_file",
                               block_row=n // bn, chunk_bytes=len(chunk)):
                labels, rows, cols, vals = readers.parse_svmlight_chunk(
                    chunk, dtype, zero_based)
                if cols.size and int(cols.max()) >= n_features:
                    raise ValueError(
                        f"{path}: feature id {int(cols.max())} out of range "
                        f"for n_features={n_features} with "
                        f"zero_based={zero_based} (a 0-based file read as "
                        f"1-based shifts ids past the end)")
                k = len(labels)
                done = 0
                while done < k:
                    take = min(bn - fill, k - done)
                    lo = np.searchsorted(rows, done)
                    hi = np.searchsorted(rows, done + take)
                    if store_sparse:
                        pend[0].append(rows[lo:hi] - done + fill)
                        pend[1].append(cols[lo:hi])
                        pend[2].append(vals[lo:hi])
                    else:
                        xbuf[rows[lo:hi] - done + fill,
                             cols[lo:hi]] = vals[lo:hi]
                    ybuf[fill:fill + take, 0] = labels[done:done + take]
                    fill += take
                    done += take
                    n += take
                    if fill == bn:
                        _flush(bn)
                        fill = 0
        if fill:
            _flush(fill)
        if n == 0:
            raise ValueError(f"{path}: no data rows")
        if store_sparse:
            x = builder.finalize()
        else:
            x = _stack_blockrows(x_blockrows, n, n_features, (bn, bm))
        y = _stack_blockrows(y_blockrows, n, 1, (bn, 1))
        return x, y


# ---------------------------------------------------------------------------
# Materializing loaders (small files / full-array paths)
# ---------------------------------------------------------------------------


def load_txt(path: str, block_shape: Tuple[int, int], delimiter: str = ",",
             dtype=np.float32, block_format: str = "dense",
             device="cuda") -> DsArray:
    """Load a delimited text file into a ds-array (one full-file parse —
    prefer :func:`load_txt_file` for anything that does not trivially fit
    in host memory)."""
    _fire("io_load", source="load_txt", path=path)
    data = np.loadtxt(path, delimiter=delimiter, dtype=dtype, ndmin=2)
    return from_array_auto(data, block_shape, block_format, device=device)


def load_npy_rows(path: str, block_shape: Tuple[int, int],
                  row_range: Optional[Tuple[int, int]] = None,
                  block_format: str = "dense", device="cuda") -> DsArray:
    """Memory-mapped .npy load; reads only the requested row range.

    The default dense path streams block rows straight off the map — each
    ``(bn, m)`` slice copies into a fresh block-row buffer and on to
    ``device``, so host memory stays O(block row) and untouched pages are
    never faulted in; ``io_load`` fires once per block row too.
    ``"auto"`` (density scan) and ``"bcoo"`` read the range in full.
    """
    _fire("io_load", source="load_npy_rows", path=path)
    dev = resolve_device(device)
    mm = np.load(path, mmap_mode="r")
    if mm.ndim == 1:
        mm = mm.reshape(-1, 1)
    if row_range is not None:
        mm = mm[row_range[0]: row_range[1]]
    if block_format != "dense":
        return from_array_auto(np.array(mm), block_shape, block_format,
                               device=dev)
    bn, bm = int(block_shape[0]), int(block_shape[1])
    n, m = mm.shape
    if n == 0:
        raise ValueError(f"{path}: empty row range")
    gm = max(1, ceil_div(m, bm))
    blockrows = []
    with _tracing.span("ingest.load", source="load_npy_rows", path=path):
        for i in range(0, n, bn):
            _fire("io_load", source="load_npy_rows", path=path,
                  block_row=i // bn)
            buf = np.zeros((bn, gm * bm), mm.dtype)
            k = min(bn, n - i)
            buf[:k, :m] = mm[i:i + k]
            blockrows.append(_blockrow_to_device(buf, gm, bm, dev))
        return _stack_blockrows(blockrows, n, m, (bn, bm))


def load_npz_sparse(path: str, block_shape: Tuple[int, int],
                    device="cuda") -> DsArray:
    """scipy.sparse ``.npz`` file -> sparse ds-array on ``device``, never
    densified (the paper's CSVM datasets ship in this form)."""
    _fire("io_load", source="load_npz_sparse", path=path)
    import scipy.sparse as ssp
    from repro_torch.core import sparse as sparse_mod
    return sparse_mod.from_scipy(ssp.load_npz(path), block_shape,
                                 device=device)


# ---------------------------------------------------------------------------
# Spill / round-trip formats (the reference's files, byte for byte)
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_npy(path: str, a: DsArray) -> None:
    """Write the dense global array.  Sparse ds-arrays raise — ``collect``
    would densify the whole matrix silently; use :func:`save_blocks`
    (sparse-aware) or ``a.todense()`` when the densification is meant."""
    if a.block_format == "bcoo":
        raise ValueError(
            "save_npy writes the dense n x m array and would silently "
            "densify a BCOO ds-array; use save_blocks(dirpath, a) for a "
            "sparse-preserving spill, or save_npy(path, a.todense()) to "
            "densify explicitly")
    np.save(path, _host(a.collect()))


def save_blocks(dirpath: str, a: DsArray) -> None:
    """One file per block row (what each PyCOMPSs worker writes).  Dense
    arrays spill one ``blockrow_*.npy`` per block row; sparse arrays spill
    ``blockrow_*.data.npy`` + ``blockrow_*.indices.npy`` and record nse and
    flags in the metadata, so the round trip keeps the block format
    without ever densifying.

    A distributed array is written whole, as the reference writes it: every
    rank gathers the blocks (a collective call), rank 0 writes the files,
    and all ranks meet at a barrier before returning, so the files are the
    ones the same blocks write undistributed."""
    a = a.ensure_zero_pad()
    placed = a.is_distributed
    if placed:
        import torch.distributed as dist
        a = a._gathered()
        if dist.get_rank() != 0:
            dist.barrier()
            return
    os.makedirs(dirpath, exist_ok=True)
    meta = {"shape": list(a.shape), "block_shape": list(a.block_shape),
            "stacked_grid": list(a.stacked_grid),
            "format": a.block_format}
    if a.block_format == "bcoo":
        sp = a.blocks
        meta.update(dtype=str(_host(sp.data[:0]).dtype), nse=int(sp.nse),
                    indices_sorted=bool(sp.indices_sorted),
                    unique_indices=bool(sp.unique_indices))
        gn = sp.data.shape[0]
        rows = [(f"blockrow_{i:05d}.data.npy", sp.data[i]) for i in range(gn)]
        rows += [(f"blockrow_{i:05d}.indices.npy", sp.indices[i])
                 for i in range(gn)]
    else:
        meta["dtype"] = str(_host(a.blocks[:0]).dtype)
        rows = [(f"blockrow_{i:05d}.npy", a.blocks[i])
                for i in range(a.blocks.shape[0])]
    with open(os.path.join(dirpath, "meta.json"), "w") as f:
        json.dump(meta, f)
    for name, t in rows:
        np.save(os.path.join(dirpath, name), _host(t))
    if placed:
        dist.barrier()


def load_blocks(dirpath: str, device="cuda") -> DsArray:
    """The ds-array :func:`save_blocks` spilled (by either package), block
    row by block row onto ``device``."""
    _fire("io_load", source="load_blocks", path=dirpath)
    from repro_torch.core.sparse import StackedCOO
    dev = resolve_device(device)

    def row(name: str) -> torch.Tensor:
        arr = np.load(os.path.join(dirpath, name))
        return torch.from_numpy(arr).to(device=dev,
                                         dtype=_torch_dtype(arr.dtype))

    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    gn = meta["stacked_grid"][0]
    grid = BlockGrid(tuple(meta["shape"]), tuple(meta["block_shape"]))
    if meta.get("format", "dense") == "bcoo":
        data = torch.stack([row(f"blockrow_{i:05d}.data.npy")
                            for i in range(gn)])
        indices = torch.stack([row(f"blockrow_{i:05d}.indices.npy")
                               for i in range(gn)])
        blocks = StackedCOO(data, indices, grid.stacked_shape,
                            indices_sorted=meta.get("indices_sorted", False),
                            unique_indices=meta.get("unique_indices", False))
        return DsArray(blocks, grid)
    return DsArray(torch.stack([row(f"blockrow_{i:05d}.npy")
                                for i in range(gn)]), grid)
