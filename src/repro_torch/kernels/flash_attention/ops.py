"""Public fused-attention entry point.

A CUDA tensor of f32, bf16 or f16 launches the CUDA kernel
(``kernel.flash_attention``); a CPU tensor takes the plain version
(``ref.attention_ref``); a ``meta`` tensor, which holds no data, gets the
kernel's output shape, dtype and layout (``kernel.flash_attention_meta``,
what a dry run sees); anything else raises.  Unlike the TPU wrapper
nothing is padded: the kernel takes any head dim up to 256 and any
sequence lengths, and ``kv_len`` is a runtime argument.

Either forward runs inside :class:`AttentionFunction`, whose backward is the
plain version's gradient, recomputed in q-chunks (``ref.attention_grads``):
no kernel of the backward is launched, and no launch is counted for it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _record
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_grads, attention_ref

__all__ = ["flash_attention", "attention_ref", "attention_grads",
           "AttentionFunction"]


class AttentionFunction(torch.autograd.Function):
    """``forward(q, k, v, forward_fn, kw)`` = ``forward_fn(q, k, v, **kw)``
    (the kernel or the plain version), with the gradient of the plain
    version: ``ref.attention_grads`` on the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, forward_fn, kw):
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return forward_fn(q, k, v, **kw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*attention_grads(q, k, v, do, **ctx.kw), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    sm_scale: Optional[float] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q ``(B, Hq, Tq, D)``, k/v ``(B, Hkv, Tk, D)`` -> ``(B, Hq, Tq, D)``.
    ``sm_scale`` defaults to ``1/sqrt(D)``; ``kv_len`` (default ``Tk``)
    hides keys at positions ``>= kv_len``.  Differentiable in q, k and v."""
    _build.refuse_dtensor("flash_attention", q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    kw = dict(causal=causal, window=window, softcap=softcap,
              sm_scale=sm_scale, q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cpu":
        forward_fn = attention_ref
    elif q.device.type == "cuda":
        forward_fn = kernel.flash_attention
    elif q.device.type == "meta":
        forward_fn = kernel.flash_attention_meta
    else:
        raise ValueError(f"no flash_attention for device {q.device}")
    return _record.kernel("flash_attention", AttentionFunction.apply, q, k, v,
                          forward_fn, kw)
