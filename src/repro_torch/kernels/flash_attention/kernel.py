"""ctypes wrapper of the CUDA fused attention (``csrc/flash_attention.cu``).

``flash_attention`` takes CUDA tensors only; ``ops`` routes CPU tensors to
the plain version.  q, k and v are read through their strides (the last dim
must be contiguous), so the permuted ``(B, T, H, D) -> (B, H, T, D)`` views
of the models need no copy; the output is allocated as ``(B, Tq, Hq, D)``
and returned as its ``(B, Hq, Tq, D)`` view, so the models' transpose back
is free.

``route`` picks the kernel before the launch: ``"rows"`` (Tq <= 8, one
block per query row), ``"wgmma"`` (tensor cores and TMA: bf16/f16, D a
multiple of 16 up to 256, q/k/v views TMA can read), else ``"tile"`` (the
SIMT tile kernel: fp32, other head dims, unaligned strides).
``flash_attention.launches`` counts the calls that launched a kernel,
``flash_attention.route_launches`` the same calls by route.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
ROW_QUERIES = 8           # Tq up to this takes the rows kernel
ROUTES = ("rows", "wgmma", "tile")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
_ENTRIES = {"rows": "flash_attention_launch", "tile": "flash_attention_launch",
            "wgmma": "flash_attention_wgmma_launch"}


def _launcher(name: str):
    fn = getattr(_build.library("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _tma_readable(t: torch.Tensor) -> bool:
    """TMA reads ``t`` (B, H, T, D) as a rank-4 map: unit stride on D, the
    other strides (of dims longer than 1) multiples of 16 bytes, a
    16-byte-aligned base."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(n == 1 or (s * es) % 16 == 0
                    for n, s in zip(t.shape[:3], t.stride()[:3])))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that attention of these tensors launches (see the module
    docstring); a function of shapes, dtypes and strides only."""
    if q.shape[2] <= ROW_QUERIES:
        return "rows"
    d = q.shape[3]
    if (q.dtype in (torch.bfloat16, torch.float16) and d % 16 == 0
            and d <= MAX_HEAD_DIM and all(map(_tma_readable, (q, k, v)))):
        return "wgmma"
    return "tile"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, device: str):
    """(b, hq, hkv, tq, tk, d) of a call on ``device`` tensors the kernel takes;
    raises as the launch does for any other."""
    _build.refuse_dtensor("flash_attention", q, k, v)
    _build.refuse_grad("flash_attention", q, k, v)
    tensors = (q, k, v)
    if any(t.device.type != device or t.device != q.device for t in tensors):
        raise ValueError(f"flash_attention wants {device.upper()} tensors on "
                         f"one device, got {[str(t.device) for t in tensors]}")
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
    return b, hq, hkv, tq, tk, d


def _output(q: torch.Tensor, b: int, hq: int, tq: int, d: int) -> torch.Tensor:
    """The kernel's output buffer, ``(B, Tq, Hq, D)``, as its (B, Hq, Tq, D)
    view."""
    return torch.empty((b, tq, hq, d), dtype=q.dtype,
                       device=q.device).permute(0, 2, 1, 3)


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         **kw) -> torch.Tensor:
    """What :func:`flash_attention` returns for these operands, on ``meta``
    tensors: the output's shape, dtype and layout, after the same checks.
    A meta tensor holds no data, so nothing is launched and nothing is
    counted: this is how a dry run (``launch.dryrun``) sees the kernel."""
    b, hq, _, tq, _, d = _check(q, k, v, "meta")
    return _output(q, b, hq, tq, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, softcap: float, sm_scale: float,
                    q_offset: int = 0, kv_len: Optional[int] = None
                    ) -> torch.Tensor:
    """Attention on the card; see ``ref.attention_ref`` for the function."""
    b, hq, hkv, tq, tk, d = _check(q, k, v, "cuda")
    tensors = (q, k, v)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in tensors)
    kv = tk if kv_len is None else max(0, min(int(kv_len), tk))
    out = _output(q, b, hq, tq, d)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    r = route(q, k, v)
    err = _launcher(_ENTRIES[r])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), b, hq, hkv, tq, tk, d, int(causal),
        int(window), int(q_offset), kv, float(sm_scale), float(softcap),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise _build.KernelError(f"flash_attention ({r}) launch failed with "
                                 f"cudaError {err}")
    flash_attention.launches += 1
    flash_attention.route_launches[r] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
