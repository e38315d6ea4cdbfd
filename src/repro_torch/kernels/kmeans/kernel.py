"""ctypes wrapper of the CUDA K-means assignment (``csrc/kmeans_assign.cu``).

``kmeans_assign_stacked`` takes CUDA tensors only; ``ops`` routes CPU
tensors to the plain version.  ``kmeans_assign_stacked.launches`` counts the
calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.blocking import ceil_div
from repro_torch.kernels import _build

TILE_ROWS = (256, 128, 64, 32)   # 1, 2, 4 or 8 of the kernel's 256 threads per row
GROUP = 8                        # centers per pass over a row in the .cu
THREADS = 256
BLOCKS_PER_SM = 2
SUM_BLOCKS_PER_SM = 4            # sums pass: (column slices x row groups) blocks
SCRATCH_BYTES = 256 << 20        # cap on the (blocks, k, d+1) partials
# the D-tiled layout: 32-row tiles, one group of 8 centers per thread of a
# row, features staged D_SLICES[i] at a time (the first that fits)
DTILED_ROWS = 32
DTILED_CHUNK = GROUP * THREADS // DTILED_ROWS
D_SLICES = (256, 128, 64, 32)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


class Plan(NamedTuple):
    """How the kernel lays out one call: rows per tile, centers staged at a
    time, whether the ``(k, d+1)`` partial lives in shared memory, and the
    features staged at a time (0: whole rows; else the D-tiled layout)."""
    tile_rows: int
    chunk: int
    smem_partial: bool
    d_slice: int = 0


def _lib():
    lib = _build.library("kmeans_assign")
    if lib.kmeans_assign_launch.argtypes is None:
        lib.kmeans_assign_launch.argtypes = _ARGTYPES
        lib.kmeans_assign_launch.restype = ctypes.c_int
        lib.kmeans_assign_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.kmeans_assign_smem_bytes.restype = ctypes.c_longlong
        lib.kmeans_assign_smem_limit.argtypes = [ctypes.c_int]
        lib.kmeans_assign_smem_limit.restype = ctypes.c_int
    return lib


def launch_plan(lib, k: int, d: int, device_index: int) -> Plan:
    """The first layout that fits one block's shared memory, in order: the
    partial on chip before in global scratch, the whole center table before
    halved chunks (multiples of 8 centers), then the largest row tile; and
    where no whole-row tile fits, the D-tiled layout with the widest slice
    that fits (its size depends on neither k nor d)."""
    limit = lib.kmeans_assign_smem_limit(device_index)
    chunks = [ceil_div(k, GROUP) * GROUP]
    while chunks[-1] > GROUP:
        chunks.append(ceil_div(chunks[-1] // 2, GROUP) * GROUP)
    for smem_partial in (True, False):
        for chunk in chunks:
            for rows in TILE_ROWS:
                if lib.kmeans_assign_smem_bytes(k, d, rows, chunk,
                                                int(smem_partial), 0) <= limit:
                    return Plan(rows, chunk, smem_partial)
    chunk = min(chunks[0], DTILED_CHUNK)
    fits = [ds for ds in D_SLICES if lib.kmeans_assign_smem_bytes(
        k, d, DTILED_ROWS, chunk, 0, ds) <= limit]
    return Plan(DTILED_ROWS, chunk, False, (fits or D_SLICES[-1:])[0])


def kmeans_assign_stacked(blocks: torch.Tensor, centers: torch.Tensor, n: int):
    """Assignment step on the card: labels ``(gn*bn,)`` int32 (-1 for rows
    >= n), sums ``(k, gm*bm)`` f32, counts ``(k,)`` f32.  ``blocks`` is the
    contiguous f32 ``(gn, gm, bn, bm)`` tensor, ``centers`` contiguous f32
    ``(k, gm*bm)`` on the same device.  ``launch_plan`` picks the layout;
    the labels do not depend on it."""
    if blocks.device.type != "cuda" or centers.device != blocks.device:
        raise ValueError(f"kmeans_assign wants CUDA tensors on one device, got "
                         f"{blocks.device} and {centers.device}")
    if blocks.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError(f"kmeans_assign takes f32, got {blocks.dtype} and "
                        f"{centers.dtype}")
    if blocks.ndim != 4 or not blocks.is_contiguous() \
            or not centers.is_contiguous():
        raise ValueError("kmeans_assign wants a contiguous rank-4 block tensor "
                         "and contiguous centers")
    gn, gm, bn, bm = blocks.shape
    k, d = centers.shape
    if d != gm * bm or k < 1 or not 0 <= n <= gn * bn:
        raise ValueError(f"kmeans_assign: centers {tuple(centers.shape)} do "
                         f"not match blocks {tuple(blocks.shape)} (n={n})")
    lib = _lib()
    dev = blocks.device
    plan = launch_plan(lib, k, d, dev.index or 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # one (k, d+1) partial per block of the assignment kernel when it lives
    # on chip, else per row group of the sums pass
    label_blocks = min(ceil_div(gn * bn, plan.tile_rows), BLOCKS_PER_SM * sms)
    cap = max(1, SCRATCH_BYTES // (4 * k * (d + 1)))
    if plan.smem_partial:
        nblocks = min(label_blocks, cap)
    else:
        groups = ceil_div(SUM_BLOCKS_PER_SM * sms, ceil_div(d + 1, THREADS))
        nblocks = max(1, min(groups, n, cap))
    labels = torch.empty(gn * bn, dtype=torch.int32, device=dev)
    partials = torch.empty((nblocks, k, d + 1), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    err = lib.kmeans_assign_launch(
        blocks.data_ptr(), centers.data_ptr(), labels.data_ptr(),
        partials.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        gn, gm, bn, bm, n, k, plan.tile_rows, plan.chunk,
        int(plan.smem_partial), plan.d_slice, label_blocks, nblocks,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign launch failed with cudaError {err}")
    kmeans_assign_stacked.launches += 1
    return labels, sums, counts


kmeans_assign_stacked.launches = 0
