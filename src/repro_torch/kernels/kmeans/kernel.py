"""ctypes wrapper of the CUDA K-means assignment (``csrc/kmeans_assign.cu``).

``kmeans_assign_stacked`` takes CUDA tensors only; ``ops`` routes CPU
tensors to the plain version.  ``route`` picks the kernel before the launch:
``"mma"`` (3xTF32 distances on the tensor cores: at most ``K_MMA`` centers,
one block column (gm == 1, so TMA reads the block tensor as rows),
``bm % 4 == 0``, contiguous tensors with 16-byte-aligned bases), else
``"simt"`` (IEEE fp32 on the CUDA cores, any shape, laid out by
``launch_plan``).  On the mma route, ``resident`` picks the form: the
center table on chip and the sums fused (``k <= K_RESIDENT``, padded rows
of at most ``D_RESIDENT`` features), else center slabs streamed beside the
rows and a sums pass.
``kmeans_assign_stacked.launches`` counts the calls that launched a kernel,
``kmeans_assign_stacked.route_launches`` the same calls by route.  A failed
launch raises; no route falls back to another.
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
ROUTES = ("mma", "simt")
K_MMA = 128                      # mma route: one pass of register accumulators
K_RESIDENT, D_RESIDENT = 64, 128  # its resident form (center table on chip)
_MMA_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


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
        lib.kmeans_assign_mma_launch.argtypes = _MMA_ARGTYPES
        lib.kmeans_assign_mma_launch.restype = ctypes.c_int
        lib.kmeans_assign_mma_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.kmeans_assign_mma_smem_bytes.restype = ctypes.c_longlong
        lib.kmeans_assign_mma_table_floats.argtypes = [ctypes.c_int] * 2
        lib.kmeans_assign_mma_table_floats.restype = ctypes.c_longlong
        lib.kmeans_assign_mma_blocks.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 2
        lib.kmeans_assign_mma_blocks.restype = ctypes.c_int
    return lib


def route(blocks: torch.Tensor, centers: torch.Tensor) -> str:
    """The kernel that ``kmeans_assign_stacked`` of these f32 tensors
    launches (see the module docstring); a function of shapes, strides and
    alignment only."""
    if (centers.shape[0] <= K_MMA and blocks.shape[1] == 1 and blocks.shape[-1] % 4 == 0
            and blocks.is_contiguous() and centers.is_contiguous()
            and blocks.data_ptr() % 16 == 0 and centers.data_ptr() % 16 == 0):
        return "mma"
    return "simt"


def resident(lib, k: int, d: int, device_index: int) -> bool:
    """Whether the mma route keeps the center table on chip and fuses the
    sums: ``k <= K_RESIDENT``, ``d`` padded to 8 at most ``D_RESIDENT``,
    and its shared memory fits one block."""
    return (k <= K_RESIDENT and ceil_div(d, 8) * 8 <= D_RESIDENT
            and lib.kmeans_assign_mma_smem_bytes(k, d, 1)
            <= lib.kmeans_assign_smem_limit(device_index))


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


def _sum_groups(n: int, k: int, d: int, sms: int) -> int:
    """Row groups of the sums pass: one (k, d+1) partial each."""
    groups = ceil_div(SUM_BLOCKS_PER_SM * sms, ceil_div(d + 1, THREADS))
    return max(1, min(groups, n, SCRATCH_BYTES // (4 * k * (d + 1))))


def kmeans_assign_stacked(blocks: torch.Tensor, centers: torch.Tensor, n: int):
    """Assignment step on the card: labels ``(gn*bn,)`` int32 (-1 for rows
    >= n), sums ``(k, gm*bm)`` f32, counts ``(k,)`` f32.  ``blocks`` is the
    contiguous f32 ``(gn, gm, bn, bm)`` tensor, ``centers`` contiguous f32
    ``(k, gm*bm)`` on the same device.  ``route`` picks the kernel."""
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    labels = torch.empty(gn * bn, dtype=torch.int32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    r = route(blocks, centers)
    if r == "mma":
        fused = resident(lib, k, d, dev.index or 0)
        label_blocks = lib.kmeans_assign_mma_blocks(gn * bn, int(fused), sms)
        nblocks = label_blocks if fused else _sum_groups(n, k, d, sms)
        partials = torch.empty((nblocks, k, d + 1), dtype=torch.float32, device=dev)
        table = torch.empty(lib.kmeans_assign_mma_table_floats(k, d),
                            dtype=torch.float32, device=dev)
        err = lib.kmeans_assign_mma_launch(
            blocks.data_ptr(), centers.data_ptr(), labels.data_ptr(),
            partials.data_ptr(), sums.data_ptr(), counts.data_ptr(),
            table.data_ptr(), gn, gm, bn, bm, n, k, int(fused), label_blocks, nblocks,
            stream)
    else:
        plan = launch_plan(lib, k, d, dev.index or 0)
        # one (k, d+1) partial per block of the assignment kernel when it
        # lives on chip, else per row group of the sums pass
        label_blocks = min(ceil_div(gn * bn, plan.tile_rows), BLOCKS_PER_SM * sms)
        cap = max(1, SCRATCH_BYTES // (4 * k * (d + 1)))
        nblocks = (min(label_blocks, cap) if plan.smem_partial
                   else _sum_groups(n, k, d, sms))
        partials = torch.empty((nblocks, k, d + 1), dtype=torch.float32, device=dev)
        err = lib.kmeans_assign_launch(
            blocks.data_ptr(), centers.data_ptr(), labels.data_ptr(),
            partials.data_ptr(), sums.data_ptr(), counts.data_ptr(),
            gn, gm, bn, bm, n, k, plan.tile_rows, plan.chunk,
            int(plan.smem_partial), plan.d_slice, label_blocks, nblocks, stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign ({r}) launch failed with cudaError {err}")
    kmeans_assign_stacked.launches += 1
    kmeans_assign_stacked.route_launches[r] += 1
    return labels, sums, counts


kmeans_assign_stacked.launches = 0
kmeans_assign_stacked.route_launches = dict.fromkeys(ROUTES, 0)
