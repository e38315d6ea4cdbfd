"""Public GEMM entry points: the stacked ``local_matmul`` under every ds-array
``@`` and ``matmul_ta``, and the 2-D ``matmul``.

A CUDA tensor of f32/bf16/f16 launches the CUDA kernel
(``kernel.stacked_matmul``); a CPU tensor takes the plain version
(``ref.stacked_matmul_ref``); a CUDA tensor of any other dtype raises.
``gemm.dispatch_cuda`` / ``gemm.dispatch_plain`` count the decisions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.matmul import kernel
from repro_torch.kernels.matmul.ref import matmul_ref, stacked_matmul_ref
from repro_torch.obs import metrics as _metrics

__all__ = ["local_matmul", "matmul", "stacked_matmul_ref", "matmul_ref"]

_DISPATCHES = _metrics.CounterGroup("gemm", ("dispatch_cuda", "dispatch_plain"))


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
