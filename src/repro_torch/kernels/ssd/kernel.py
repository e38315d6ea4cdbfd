"""ctypes wrapper of the CUDA SSD chunk kernel (``csrc/ssd_chunk.cu``).

``ssd_chunk`` takes CUDA f32 tensors only; ``ops`` routes CPU tensors to the
plain version.  Inputs are read through their strides (the last dim
contiguous); b and c may be per group, ``(BG, T, S)``, read by a head ->
group map instead of being copied per head.

``route`` picks the kernel before the launch: ``"mma"`` (3xTF32 on the
tensor cores: chunk a multiple of 16, P and S multiples of 8, x, b and c
rows that 16-byte ``cp.async`` copies can read), else ``"simt"`` (IEEE fp32
on the CUDA cores, any shape up to 128).  ``ssd_chunk.launches`` counts the
calls that launched a kernel, ``ssd_chunk.route_launches`` the same calls by
route.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_DIM = 128    # chunk length, head dim and state size
ROUTES = ("mma", "simt")
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ENTRIES = {"mma": "ssd_chunk_mma_launch", "simt": "ssd_chunk_launch"}


def _launcher(name: str):
    fn = getattr(_build.library("ssd_chunk"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _copyable(t: torch.Tensor) -> bool:
    """Rows of ``t`` that 16-byte ``cp.async`` copies can read: unit stride
    on the last dim, the other strides (of dims longer than 1) multiples of
    4 floats, a 16-byte-aligned base."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(n == 1 or s % 4 == 0
                    for n, s in zip(t.shape[:-1], t.stride()[:-1])))


def route(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor, chunk: int) -> str:
    """The kernel that ``ssd_chunk`` of these f32 tensors launches (see the
    module docstring); a function of shapes, strides and alignment only."""
    p, s = x.shape[-1], b.shape[-1]
    if (chunk % 16 == 0 and p % 8 == 0 and s % 8 == 0
            and max(chunk, p, s) <= MAX_DIM and all(map(_copyable, (x, b, c)))):
        return "mma"
    return "simt"


def _check(x, dt, a, b, c, chunk: int, device: str):
    """(bh, t, p, bg, s) of a call on ``device`` tensors the kernel takes;
    raises as the launch does for any other."""
    _build.refuse_dtensor("ssd_chunk", x, dt, a, b, c)
    _build.refuse_grad("ssd_chunk", x, dt, a, b, c)
    tensors = (x, dt, a, b, c)
    if any(v.dtype != torch.float32 for v in tensors):
        raise TypeError(f"ssd_chunk takes f32, got {[v.dtype for v in tensors]}")
    if any(v.device.type != device or v.device != x.device for v in tensors):
        raise ValueError(f"ssd_chunk wants {device.upper()} tensors on one "
                         f"device, got {[str(v.device) for v in tensors]}")
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
    return bh, t, p, bg, s


def _outputs(dev, bh: int, t: int, p: int, s: int, nc: int):
    """The kernel's four f32 outputs: y, states, C ⊙ exp(ℓ), the decay."""
    return (torch.empty((bh, t, p), dtype=torch.float32, device=dev),
            torch.empty((bh, nc, s, p), dtype=torch.float32, device=dev),
            torch.empty((bh, t, s), dtype=torch.float32, device=dev),
            torch.empty((bh, nc), dtype=torch.float32, device=dev))


def ssd_chunk_meta(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *, chunk: int):
    """What :func:`ssd_chunk` returns for these operands, on ``meta``
    tensors: the outputs' shapes, dtypes and layouts, after the same
    checks.  A meta tensor holds no data, so nothing is launched and nothing
    is counted: this is how a dry run (``launch.dryrun``) sees the kernel."""
    bh, t, p, _, s = _check(x, dt, a, b, c, chunk, "meta")
    return _outputs(x.device, bh, t, p, s, t // chunk)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *, chunk: int):
    """Chunk-local SSD terms on the card; see ``ref.ssd_chunk_ref``."""
    bh, t, p, bg, s = _check(x, dt, a, b, c, chunk, "cuda")
    x, dt, b, c = (_rows(v) for v in (x, dt, b, c))
    a = a.contiguous()
    nc = t // chunk
    dev = x.device
    y, states, c_dec, decay = _outputs(dev, bh, t, p, s, nc)
    strides = (ctypes.c_longlong * 8)(*x.stride()[:2], dt.stride(0),
                                      dt.stride(1), *b.stride()[:2],
                                      *c.stride()[:2])
    r = route(x, dt, b, c, chunk)
    err = _launcher(_ENTRIES[r])(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), states.data_ptr(), c_dec.data_ptr(), decay.data_ptr(),
        ctypes.addressof(strides), bh, t, p, s, chunk, bh // bg,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise _build.KernelError(f"ssd_chunk ({r}) launch failed with cudaError {err}")
    ssd_chunk.launches += 1
    ssd_chunk.route_launches[r] += 1
    return y, states, c_dec, decay


ssd_chunk.launches = 0
ssd_chunk.route_launches = dict.fromkeys(ROUTES, 0)
