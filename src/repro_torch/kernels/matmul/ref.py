"""Plain PyTorch versions of the stacked GEMM: the CPU path of
``ops.local_matmul`` and what ``chip_smoke.py`` holds the CUDA kernel to."""

from __future__ import annotations

import torch


def _accumulator(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    """fp32 (or wider) accumulation for floating inputs, as the reference's
    ``preferred_element_type``; integer inputs keep their type."""
    ct = torch.promote_types(a.dtype, b.dtype)
    return torch.promote_types(ct, torch.float32) if ct.is_floating_point else ct


def stacked_matmul_ref(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
                       transpose_a: bool = False) -> torch.Tensor:
    """``(gi, gk, bn, bk) x (gk, gj, bk, bm) -> (gi, gj, bn, bm)`` as one
    stacked einsum; ``transpose_a=True`` reads ``a`` as ``(gk, gi, bk, bn)``."""
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    acc = _accumulator(a, b)
    spec = "kiba,kjbc->ijac" if transpose_a else "ikab,kjbc->ijac"
    return torch.einsum(spec, a.to(acc), b.to(acc)).to(out_dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """2-D ``a @ b`` with fp32 accumulation; output in ``out_dtype`` or
    ``a.dtype``, as ``repro.kernels.matmul.ref.matmul_ref``."""
    acc = _accumulator(a, b)
    return (a.to(acc) @ b.to(acc)).to(out_dtype or a.dtype)
