"""ctypes wrapper of the CUDA SSD chunk kernel (``csrc/ssd_chunk.cu``).

``ssd_chunk`` takes CUDA f32 tensors only; ``ops`` routes CPU tensors to the
plain version.  Inputs are read through their strides (the last dim
contiguous); b and c may be per group, ``(BG, T, S)``, read by a head ->
group map instead of being copied per head.  ``ssd_chunk.launches`` counts
the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_DIM = 128    # chunk length, head dim and state size
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _lib():
    lib = _build.library("ssd_chunk")
    if lib.ssd_chunk_launch.argtypes is None:
        lib.ssd_chunk_launch.argtypes = _ARGTYPES
        lib.ssd_chunk_launch.restype = ctypes.c_int
    return lib


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *, chunk: int):
    """Chunk-local SSD terms on the card; see ``ref.ssd_chunk_ref``."""
    tensors = (x, dt, a, b, c)
    if any(v.device.type != "cuda" or v.device != x.device for v in tensors):
        raise ValueError("ssd_chunk wants CUDA tensors on one device, got "
                         f"{[str(v.device) for v in tensors]}")
    if any(v.dtype != torch.float32 for v in tensors):
        raise TypeError(f"ssd_chunk takes f32, got {[v.dtype for v in tensors]}")
    bh, t, p = x.shape
    bg, s = b.shape[0], b.shape[-1]
    if (dt.shape != (bh, t) or a.shape != (bh,) or b.shape != (bg, t, s)
            or c.shape != b.shape or bg < 1 or bh % bg or t % chunk
            or not (1 <= chunk <= MAX_DIM and 1 <= p <= MAX_DIM
                    and 1 <= s <= MAX_DIM)):
        raise ValueError(
            f"ssd_chunk: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, chunk "
            f"{chunk} (T a multiple of chunk; chunk, P, S <= {MAX_DIM})")
    x, dt, b, c = (_rows(v) for v in (x, dt, b, c))
    a = a.contiguous()
    nc = t // chunk
    dev = x.device
    y = torch.empty((bh, t, p), dtype=torch.float32, device=dev)
    states = torch.empty((bh, nc, s, p), dtype=torch.float32, device=dev)
    c_dec = torch.empty((bh, t, s), dtype=torch.float32, device=dev)
    decay = torch.empty((bh, nc), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 8)(*x.stride()[:2], dt.stride(0),
                                      dt.stride(1), *b.stride()[:2],
                                      *c.stride()[:2])
    err = _lib().ssd_chunk_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), states.data_ptr(), c_dec.data_ptr(), decay.data_ptr(),
        ctypes.addressof(strides), bh, t, p, s, chunk, bh // bg,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed with cudaError {err}")
    ssd_chunk.launches += 1
    return y, states, c_dec, decay


ssd_chunk.launches = 0
