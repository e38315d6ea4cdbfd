"""ctypes wrapper of the CUDA stacked GEMM (``csrc/stacked_matmul.cu``).

``stacked_matmul`` takes CUDA tensors only; ``ops.local_matmul`` routes CPU
tensors to the plain version.  ``plan`` picks the route before the launch:
``"wgmma"`` (tensor cores, TMA loads) for bf16/f16 operands whose views TMA
can read, ``"simt"`` (IEEE fp32 FMAs, any strides) for everything else.
That is dispatch by shape: nothing is retried, and a failed launch raises.
``stacked_matmul.launches`` counts the calls that launched a kernel,
``stacked_matmul.route_launches`` the same calls by route, and
``stacked_matmul.max_workspace`` is the largest split-K workspace (bytes)
a launch allocated.  ``low_memory=True`` (the resilience ladder's last
rung) holds that workspace within :data:`LOW_MEMORY_WORKSPACE` instead of
:data:`WORKSPACE`; it still splits a deep K that way where the output is
small, since one split sums the whole of K in one fp32 register per
output element.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core.blocking import ceil_div
from repro_torch.kernels import _build

#: dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: (rows, cols) of one block's output tile and the K step, per route
WGMMA_TILE = (128, 128, 64)
SIMT_TILE = (128, 128, 16)
ROUTES = ("wgmma", "simt")
_TMA_ALIGN = 16           # bytes: TMA's base alignment and stride granule
#: the split-K workspace's cap (bytes), and the cap of the low-memory form
WORKSPACE = 256 << 20
LOW_MEMORY_WORKSPACE = 4 << 20

_c_ll = ctypes.c_longlong
_SIMT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [_c_ll] * 8
                  + [ctypes.c_int, ctypes.c_void_p])
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_int] * 2
                   + [ctypes.c_int, ctypes.c_void_p])


@dataclass(frozen=True)
class TmaOperand:
    """One operand as a rank-4 TMA tensor map: ``dims`` innermost first
    (the innermost has unit stride), ``strides`` the byte strides of dims
    1..3, ``box`` the (inner, outer) extent of one load, and whether the
    innermost dim is K (else M or N)."""
    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int]
    k_major: bool


@dataclass(frozen=True)
class GemmPlan:
    route: str                     # "wgmma" or "simt"
    tile: Tuple[int, int, int]     # output rows, output cols, K step
    splits: int                    # K splits (1: no workspace)
    a: Optional[TmaOperand] = None   # the wgmma route's operand maps
    b: Optional[TmaOperand] = None


def _launcher(name: str, argtypes):
    fn = getattr(_build.library("stacked_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def split_count(tiles: int, k_steps: int, out_elems: int, sms: int,
                workspace: int = WORKSPACE) -> int:
    """How many K splits to run: 1 when the output tiles alone fill the card;
    else enough to give ~4 blocks per SM, keeping >= 64 K steps per split
    and the fp32 workspace within ``workspace`` bytes."""
    if tiles >= 2 * sms:
        return 1
    want = ceil_div(4 * sms, tiles)
    by_depth = max(1, k_steps // 64)
    by_workspace = max(1, workspace // 4 // max(1, out_elems))
    return max(1, min(want, by_depth, by_workspace, 65535))


def tma_operand(t: torch.Tensor, k_dim: int, mn_dim: int,
                grid_dims: Tuple[int, int]) -> Optional[TmaOperand]:
    """The TMA description of a rank-4 16-bit operand whose K dim is
    ``k_dim``, M or N dim ``mn_dim`` and grid dims ``grid_dims`` (inner
    first), or None when TMA cannot read it: it needs a 16-byte-aligned
    base, a unit stride on the K or the MN dim (K preferred), and every
    other stride a multiple of 16 bytes.  A dim of size 1 has no stride to
    check; it gets the packed one, as the C side encodes it."""
    if t.element_size() != 2 or t.data_ptr() % _TMA_ALIGN:
        return None
    shape, stride = t.shape, t.stride()
    for k_major in (True, False):
        inner, outer = (k_dim, mn_dim) if k_major else (mn_dim, k_dim)
        order = (inner, outer) + tuple(grid_dims)
        if shape[inner] != 1 and stride[inner] != 1:
            continue
        if any(shape[d] != 1 and (stride[d] * 2) % _TMA_ALIGN
               for d in order[1:]):
            continue
        dims = tuple(int(shape[d]) for d in order)
        strides, packed = [], dims[0] * 2
        for d, size in zip(order[1:], dims[1:]):
            packed = ceil_div(packed, _TMA_ALIGN) * _TMA_ALIGN
            strides.append(packed if size == 1 else int(stride[d]) * 2)
            packed = strides[-1] * size
        box = (WGMMA_TILE[2], WGMMA_TILE[0]) if k_major else (64, WGMMA_TILE[2])
        return TmaOperand(dims, tuple(strides), box, k_major)
    return None


def plan(av: torch.Tensor, b: torch.Tensor, sms: int,
         workspace: int = WORKSPACE) -> GemmPlan:
    """The route, tile, split count and (wgmma) operand maps of the product
    of ``av`` viewed as ``(gi, gk, bn, bk)`` and ``b`` as ``(gk, gj, bk,
    bm)`` on a card of ``sms`` SMs, its split-K workspace within
    ``workspace`` bytes."""
    gi, gk, bn, bk = av.shape
    gj, bm = b.shape[1], b.shape[3]
    a_op = b_op = None
    if av.dtype in (torch.float16, torch.bfloat16) and b.dtype == av.dtype:
        a_op = tma_operand(av, 3, 2, (1, 0))
        b_op = tma_operand(b, 2, 3, (1, 0))
    wgmma = a_op is not None and b_op is not None
    rows, cols, depth = WGMMA_TILE if wgmma else SIMT_TILE
    tiles = gi * gj * ceil_div(bn, rows) * ceil_div(bm, cols)
    splits = split_count(tiles, gk * ceil_div(bk, depth), gi * gj * bn * bm, sms,
                         workspace)
    if wgmma:
        return GemmPlan("wgmma", (rows, cols, depth), splits, a_op, b_op)
    return GemmPlan("simt", (rows, cols, depth), splits)


def _map_array(op: TmaOperand):
    return (_c_ll * 9)(*op.dims, *op.strides, *op.box)


def stacked_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype,
                   transpose_a: bool = False,
                   low_memory: bool = False) -> torch.Tensor:
    """``(gi, gk, bn, bk) x (gk, gj, bk, bm) -> (gi, gj, bn, bm)`` on the
    card; ``transpose_a=True`` takes ``a`` as ``(gk, gi, bk, bn)`` and reads
    it transposed through its strides (no copy).  Any strides are accepted;
    both operands must share one dtype among f32/f16/bf16.
    ``low_memory=True`` holds the split-K workspace within
    :data:`LOW_MEMORY_WORKSPACE`."""
    _build.refuse_dtensor("stacked_matmul", a, b)
    _build.refuse_grad("stacked_matmul", a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"stacked_matmul wants CUDA tensors on one device, "
                         f"got {a.device} and {b.device}")
    if a.dtype != b.dtype or a.dtype not in DTYPE_CODES \
            or out_dtype not in DTYPE_CODES:
        raise TypeError(f"stacked_matmul takes f32/f16/bf16, got {a.dtype} x "
                        f"{b.dtype} -> {out_dtype}")
    if a.ndim != 4 or b.ndim != 4:
        raise ValueError(f"stacked operands are rank 4, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    av = a.permute(1, 0, 3, 2) if transpose_a else a
    gi, gk, bn, bk = av.shape
    gk2, gj, bk2, bm = b.shape
    if gk != gk2 or bk != bk2:
        raise ValueError(f"stacked matmul inner mismatch {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    out = torch.empty((gi, gj, bn, bm), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    if gk * bk == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    p = plan(av, b, sms, LOW_MEMORY_WORKSPACE if low_memory else WORKSPACE)
    ws = (torch.empty((p.splits,) + tuple(out.shape), dtype=torch.float32,
                      device=a.device) if p.splits > 1 else None)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    common = (av.data_ptr(), b.data_ptr(), out.data_ptr(),
              ws.data_ptr() if ws is not None else None,
              DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype], gi, gj, gk, bn, bk, bm)
    if p.route == "wgmma":
        a_map, b_map = _map_array(p.a), _map_array(p.b)
        err = _launcher("stacked_matmul_wgmma_launch", _WGMMA_ARGTYPES)(
            *common, ctypes.addressof(a_map), int(p.a.k_major),
            ctypes.addressof(b_map), int(p.b.k_major), p.splits, stream)
    else:
        err = _launcher("stacked_matmul_launch", _SIMT_ARGTYPES)(
            *common, *av.stride(), *b.stride(), p.splits, stream)
    if err != 0:
        raise _build.KernelError(f"stacked_matmul ({p.route}) launch failed "
                                 f"with cudaError {err}")
    stacked_matmul.launches += 1
    stacked_matmul.route_launches[p.route] += 1
    if ws is not None:
        stacked_matmul.max_workspace = max(stacked_matmul.max_workspace,
                                           ws.numel() * 4)
    return out


stacked_matmul.launches = 0
stacked_matmul.route_launches = dict.fromkeys(ROUTES, 0)
stacked_matmul.max_workspace = 0
