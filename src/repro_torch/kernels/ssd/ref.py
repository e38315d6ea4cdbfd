"""Plain PyTorch versions of the SSD: the chunk-local function of the TPU
kernel (``repro.kernels.ssd.kernel._ssd_chunk_kernel``), which is the CPU
path of ``ops.ssd_chunk`` and what ``chip_smoke.py`` holds the CUDA kernel
to, and the sequential-recurrence oracle (``repro.kernels.ssd.ref``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def group_rows(bh: int, b: torch.Tensor) -> torch.Tensor:
    """``b (BG, T, S)`` with one row per head: row ``i`` of the result is
    ``b[i // (bh // BG)]`` (the identity when BG == BH)."""
    if bh % b.shape[0]:
        raise ValueError(f"{bh} heads do not split into {b.shape[0]} groups")
    return b.repeat_interleave(bh // b.shape[0], dim=0)


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, *, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Chunk-local SSD terms; T must divide by ``chunk``.

    x ``(BH, T, P)``, dt ``(BH, T)``, a ``(BH,)``, b/c ``(BG, T, S)`` with
    head ``i`` reading group ``i // (BH // BG)``.  Returns y_intra
    ``(BH, T, P)``, states ``(BH, NC, S, P)`` f32, C ⊙ exp(ℓ) ``(BH, T, S)``
    and the chunk decay exp(ℓ_L) ``(BH, NC)`` f32, where ℓ is the inclusive
    cumsum of a·dt within a chunk."""
    bh, t, p = x.shape
    s = b.shape[-1]
    nc, L = t // chunk, chunk
    xc = x.float().reshape(bh, nc, L, p)
    dtc = dt.float().reshape(bh, nc, L)
    bc = group_rows(bh, b).float().reshape(bh, nc, L, s)
    cc = group_rows(bh, c).float().reshape(bh, nc, L, s)
    ell = torch.cumsum(a.float()[:, None, None] * dtc, dim=2)     # (BH,NC,L)
    diff = ell[..., :, None] - ell[..., None, :]                   # [t, s]
    tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    # never exponentiate the masked (s > t) half: it would overflow
    gate = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    w = torch.einsum("bnls,bnms->bnlm", cc, bc) * gate
    y_intra = torch.einsum("bnlm,bnmp->bnlp", w, xc * dtc[..., None])
    w_end = torch.exp(ell[..., -1:] - ell)
    states = torch.einsum("bnls,bnlp->bnsp", bc * (w_end * dtc)[..., None], xc)
    c_dec = cc * torch.exp(ell)[..., None]
    return (y_intra.reshape(bh, t, p).to(x.dtype), states,
            c_dec.reshape(bh, t, s).to(x.dtype), torch.exp(ell[..., -1]))


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor,
            h0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence ``h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_tᵀ``,
    ``y_t = C_t h_t``, one step at a time: y ``(BH, T, P)`` in x's dtype and
    the final state ``(BH, S, P)`` f32."""
    bh, t, p = x.shape
    b, c = group_rows(bh, b).float(), group_rows(bh, c).float()
    h = (torch.zeros(bh, b.shape[-1], p, device=x.device) if h0 is None
         else h0.float())
    xf, dtf, af = x.float(), dt.float(), a.float()
    ys = []
    for i in range(t):
        h = (torch.exp(af * dtf[:, i])[:, None, None] * h
             + dtf[:, i, None, None] * (b[:, i, :, None] * xf[:, i, None, :]))
        ys.append(torch.einsum("bs,bsp->bp", c[:, i], h))
    return torch.stack(ys, 1).to(x.dtype), h
