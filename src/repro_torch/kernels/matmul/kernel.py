"""ctypes wrapper of the CUDA stacked GEMM (``csrc/stacked_matmul.cu``).

``stacked_matmul`` takes CUDA tensors only; ``ops.local_matmul`` routes CPU
tensors to the plain version.  ``stacked_matmul.launches`` counts the calls
that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.blocking import ceil_div
from repro_torch.kernels import _build

#: dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
TILE_M = TILE_N = 128     # output tile of one thread block (BM, BN in the .cu)
TILE_K = 8                # K step (BK in the .cu)

_c_ll = ctypes.c_longlong
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [_c_ll] * 8
             + [ctypes.c_int, ctypes.c_void_p])


def _launcher():
    fn = _build.library("stacked_matmul").stacked_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def split_count(tiles: int, k_steps: int, out_elems: int, sms: int) -> int:
    """How many K splits to run: 1 when the output tiles alone fill the card;
    else enough to give ~4 blocks per SM, keeping >= 64 K steps per split
    and the fp32 workspace within 256 MiB."""
    if tiles >= 2 * sms:
        return 1
    want = ceil_div(4 * sms, tiles)
    by_depth = max(1, k_steps // 64)
    by_workspace = max(1, (64 << 20) // max(1, out_elems))
    return max(1, min(want, by_depth, by_workspace, 65535))


def stacked_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype,
                   transpose_a: bool = False) -> torch.Tensor:
    """``(gi, gk, bn, bk) x (gk, gj, bk, bm) -> (gi, gj, bn, bm)`` on the
    card; ``transpose_a=True`` takes ``a`` as ``(gk, gi, bk, bn)`` and reads
    it transposed through its strides (no copy).  Any strides are accepted;
    both operands must share one dtype among f32/f16/bf16."""
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
    tiles = gi * gj * ceil_div(bn, TILE_M) * ceil_div(bm, TILE_N)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits = split_count(tiles, gk * ceil_div(bk, TILE_K), out.numel(), sms)
    ws = (torch.empty((splits,) + tuple(out.shape), dtype=torch.float32,
                      device=a.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _launcher()(av.data_ptr(), b.data_ptr(), out.data_ptr(),
                      ws.data_ptr() if ws is not None else None,
                      DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype],
                      gi, gj, gk, bn, bk, bm, *av.stride(), *b.stride(),
                      splits, stream)
    if err != 0:
        raise RuntimeError(f"stacked_matmul launch failed with cudaError {err}")
    stacked_matmul.launches += 1
    return out


stacked_matmul.launches = 0
