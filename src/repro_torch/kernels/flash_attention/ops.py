"""Public fused-attention entry point.

A CUDA tensor of f32, bf16 or f16 launches the CUDA kernel
(``kernel.flash_attention``); a CPU tensor takes the plain version
(``ref.attention_ref``); anything else raises.  Unlike the TPU wrapper
nothing is padded: the kernel takes any head dim up to 256 and any
sequence lengths, and ``kv_len`` is a runtime argument.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    sm_scale: Optional[float] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q ``(B, Hq, Tq, D)``, k/v ``(B, Hkv, Tk, D)`` -> ``(B, Hq, Tq, D)``.
    ``sm_scale`` defaults to ``1/sqrt(D)``; ``kv_len`` (default ``Tk``)
    hides keys at positions ``>= kv_len``."""
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    kw = dict(causal=causal, window=window, softcap=softcap,
              sm_scale=sm_scale, q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    return kernel.flash_attention(q, k, v, **kw)
