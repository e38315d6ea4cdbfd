"""Plain PyTorch attention: the CPU path of ``ops.flash_attention`` and what
``chip_smoke.py`` holds the CUDA kernel to.  The port of
``repro.kernels.flash_attention.ref.attention_ref`` plus ``kv_len``; and its
gradient, which is the backward of ``ops.flash_attention`` on both
devices."""

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


def attention_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, sm_scale: Optional[float] = None,
                    q_offset: int = 0, kv_len: Optional[int] = None,
                    q_chunk: int = 1024):
    """The gradient of :func:`attention_ref`: (dq, dk, dv) for the output
    gradient ``do`` (B, Hq, Tq, D), each in its input's dtype.

    fp32 throughout, recomputed ``q_chunk`` queries at a time, so that the
    live scores are (B, Hq, q_chunk, Tk) as in the reference's
    ``attention_xla``.  Per chunk: P = softmax of the masked (soft-capped)
    scores S, dV += Pᵀ dO, dP = dO Vᵀ, dS = P ∘ (dP − rowsum(P ∘ dP)),
    times 1 − tanh² under a soft-cap, then dQ = dS K·scale and dK += dSᵀ
    Q·scale.  Under GQA, dK and dV sum over each key head's group of query
    heads.  Fully masked rows (P = 0) pass no gradient."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    dq = torch.empty_like(q)
    dk = torch.zeros((b, hq, tk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    k_pos = torch.arange(tk, device=q.device)[None, :]
    for lo in range(0, tq, q_chunk):
        hi = min(tq, lo + q_chunk)
        qc, doc = q[:, :, lo:hi].float(), do[:, :, lo:hi].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * sm_scale
        if softcap > 0.0:
            cap = torch.tanh(s / softcap)
            s = softcap * cap
        q_pos = torch.arange(lo, hi, device=q.device)[:, None] + q_offset
        mask = k_pos < (tk if kv_len is None else kv_len)
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window > 0:
            mask = mask & ((q_pos - k_pos) < window)
        p = torch.softmax(s.masked_fill_(~mask, float("-inf")), dim=-1)
        del s
        p.nan_to_num_(0.0)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, doc)
        ds = torch.einsum("bhqd,bhkd->bhqk", doc, vf)
        ds -= (p * ds).sum(-1, keepdim=True)
        ds *= p
        del p
        if softcap > 0.0:
            ds *= 1.0 - cap * cap
            del cap
        ds *= sm_scale
        dq[:, :, lo:hi] = torch.einsum("bhqk,bhkd->bhqd", ds, kf).to(q.dtype)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qc)
    dk = dk.reshape(b, hkv, group, tk, d).sum(2)
    dv = dv.reshape(b, hkv, group, tk, d).sum(2)
    return dq, dk.to(k.dtype), dv.to(v.dtype)
