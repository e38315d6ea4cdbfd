"""ctypes wrapper of the CUDA fused attention (``csrc/flash_attention.cu``).

``flash_attention`` takes CUDA tensors only; ``ops`` routes CPU tensors to
the plain version.  q, k and v are read through their strides (the last dim
must be contiguous), so the permuted ``(B, T, H, D) -> (B, H, T, D)`` views
of the models need no copy; the output is allocated as ``(B, Tq, Hq, D)``
and returned as its ``(B, Hq, Tq, D)`` view, so the models' transpose back
is free.  ``flash_attention.launches`` counts the calls that launched the
kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _lib():
    lib = _build.library("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = _ARGTYPES
        lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, softcap: float, sm_scale: float,
                    q_offset: int = 0, kv_len: Optional[int] = None
                    ) -> torch.Tensor:
    """Attention on the card; see ``ref.attention_ref`` for the function."""
    tensors = (q, k, v)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_attention wants CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32/bf16/f16 of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B,Hq,Tq,D) and k, v "
                         f"(B,Hkv,Tk,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, tq, d = q.shape
    _, hkv, tk, dk = k.shape
    if (k.shape[0] != b or dk != d or hkv < 1 or hq % hkv
            or not 1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (D <= {MAX_HEAD_DIM},"
                         f" Hq a multiple of Hkv)")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in tensors)
    kv = tk if kv_len is None else max(0, min(int(kv_len), tk))
    out = torch.empty((b, tq, hq, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), b, hq, hkv, tq, tk, d, int(causal),
        int(window), int(q_offset), kv, float(sm_scale), float(softcap),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
