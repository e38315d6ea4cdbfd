"""Public SSD ops: the chunk kernel, then the inter-chunk recurrence.

    y = y_intra + (C ⊙ exp(ℓ)) @ h_prev_chunk

``ssd_chunk`` launches the CUDA kernel (``kernel.ssd_chunk``) for a CUDA
tensor and takes the plain version (``ref.ssd_chunk_ref``) for a CPU tensor;
a ``meta`` tensor gets the kernel's outputs' shapes and dtypes
(``kernel.ssd_chunk_meta``, what a dry run sees); each runs inside :class:`SSDChunkFunction`, whose backward is the plain
chunk's gradient, recomputed (``ref.ssd_chunk_grads``; no kernel launch).
The recurrence over chunk states runs as a loop over chunks in torch ops: it
is what the reference's ``associative_scan`` computes, in another order.
B and C may be per group: ``(BG, T, S)`` with BG dividing BH, head ``i``
reading group ``i // (BH // BG)``; BG == BH is the reference's layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.blocking import round_up
from repro_torch.kernels import _build, _record
from repro_torch.kernels.ssd import kernel
from repro_torch.kernels.ssd.ref import ssd_chunk_grads, ssd_chunk_ref, ssd_ref

__all__ = ["ssd_chunk", "ssd_scan", "ssd_decode_step", "ssd_chunk_ref",
           "ssd_chunk_grads", "ssd_ref", "SSDChunkFunction"]


class SSDChunkFunction(torch.autograd.Function):
    """``forward(x, dt, a, b, c, forward_fn, chunk)`` =
    ``forward_fn(x, dt, a, b, c, chunk=chunk)`` (the kernel or the plain
    version), with the gradient of the plain version for all five inputs:
    ``ref.ssd_chunk_grads`` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, forward_fn, chunk):
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return forward_fn(x, dt, a, b, c, chunk=chunk)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (*ssd_chunk_grads(*ctx.saved_tensors, grads, chunk=ctx.chunk),
                None, None)


def ssd_chunk(x, dt, a, b, c, *, chunk: int):
    """Chunk-local terms (see ``ref.ssd_chunk_ref``); T divides by chunk.
    Differentiable in x, dt, a, b and c."""
    _build.refuse_dtensor("ssd_chunk", x, dt, a, b, c)
    if x.device.type == "cpu":
        forward_fn = ssd_chunk_ref
    elif x.device.type == "cuda":
        forward_fn = kernel.ssd_chunk
    elif x.device.type == "meta":
        forward_fn = kernel.ssd_chunk_meta
    else:
        raise ValueError(f"no ssd_chunk for device {x.device}")
    return _record.kernel("ssd_chunk", SSDChunkFunction.apply, x, dt, a, b, c,
                          forward_fn, chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(BH, T, P)``, dt ``(BH, T)``, a ``(BH,)``, b/c ``(BG, T, S)``,
    h0 ``(BH, S, P)`` -> (y ``(BH, T, P)`` in x's dtype, h_final
    ``(BH, S, P)`` f32)."""
    _build.refuse_dtensor("ssd_scan", x, dt, a, b, c, h0)
    bh, t, p = x.shape
    s = b.shape[-1]
    t_pad = round_up(t, chunk)
    if t_pad != t:
        # dt = 0 steps: decay exp(0) = 1 and no input, so they change nothing
        pad = t_pad - t
        x, b, c = (torch.nn.functional.pad(v, (0, 0, 0, pad)) for v in (x, b, c))
        dt = torch.nn.functional.pad(dt, (0, pad))
    nc = t_pad // chunk
    y_intra, states, c_dec, decays = ssd_chunk(x, dt, a, b, c, chunk=chunk)
    h = (torch.zeros(bh, s, p, device=x.device) if h0 is None
         else h0.float())
    h_prev = []
    for n in range(nc):
        h_prev.append(h)
        h = decays[:, n, None, None] * h + states[:, n]
    y_inter = torch.einsum("bnls,bnsp->bnlp",
                           c_dec.float().reshape(bh, nc, chunk, s),
                           torch.stack(h_prev, 1)).reshape(bh, t_pad, p)
    y = (y_intra.float() + y_inter).to(x.dtype)
    return y[:, :t], h


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, h: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: x ``(BH, P)``, dt/a ``(BH,)``, b/c ``(BH, S)``, h
    ``(BH, S, P)`` -> (y ``(BH, P)`` in x's dtype, the new h)."""
    decay = torch.exp(a * dt)[:, None, None]
    h = decay * h + dt[:, None, None] * (b[..., None] * x[:, None, :])
    return torch.einsum("bs,bsp->bp", c, h).to(x.dtype), h
