"""Plain PyTorch attention: the CPU path of ``ops.flash_attention`` and what
``chip_smoke.py`` holds the CUDA kernel to.  The port of
``repro.kernels.flash_attention.ref.attention_ref`` plus ``kv_len``."""

from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  sm_scale: Optional[float] = None, q_offset: int = 0,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """q ``(B, Hq, Tq, D)``, k/v ``(B, Hkv, Tk, D)`` -> ``(B, Hq, Tq, D)`` in
    q's dtype.  Scores and softmax in fp32; key ``j`` is hidden where
    ``j >= kv_len``, by the causal mask (query ``i`` at position
    ``i + q_offset``) and outside the sliding ``window``; rows that see no
    key return 0."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(tq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(tk, device=q.device)[None, :]
    mask = k_pos < (tk if kv_len is None else kv_len)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window > 0:
        mask = mask & ((q_pos - k_pos) < window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)   # fully masked rows -> 0
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
