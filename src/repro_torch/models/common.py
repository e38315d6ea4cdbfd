"""Shared model building blocks, the parts of ``repro.models.common`` that the
ported families use: norms, RoPE, attention through the fused kernel, MLPs, the
losses and init helpers.

Everything is functional over parameter trees of plain dicts.  Products take
the activation dtype with fp32 accumulation inside the GEMM and round once to
the activation dtype, as the reference's ``preferred_element_type=float32``
followed by ``astype``; norm statistics, softmax and the logits are fp32.
One difference in bf16 only: where the reference applies an activation to
the fp32 product (the MLP's gate), the port applies it to the bf16-rounded
product.  In float32 the two are the same function.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    w = 1.0 + scale.float() if plus_one else scale.float()
    return (y * w).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, H, T, D); positions: (B, T) or (T,)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (D/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].float() * freqs        # (B,1,T,D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: one fused-kernel call each
# ---------------------------------------------------------------------------


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D): the function of the reference's
    ``attention_xla`` (scale 1/sqrt(D)), which needs no q-chunk scan or band
    gather here: the kernel keeps its score tiles on chip and skips the key
    tiles the masks hide.  ``causal=False`` with Tq != Tk (an encoder's
    self-attention, a decoder's cross-attention) goes to the kernel as it
    is: every query sees every key."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *,
                     softcap: float = 0.0, rolling: bool = False) -> torch.Tensor:
    """One query token (B, Hq, 1, D) against a (possibly rolling) cache
    (B, Hkv, Tmax, D) holding ``length`` tokens; a rolling cache is a
    circular buffer whose valid slots are min(length, Tmax)."""
    tmax = k_cache.shape[2]
    return flash_attention(q, k_cache, v_cache, causal=False, softcap=softcap,
                           kv_len=min(length, tmax) if rolling else length)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(params: Params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type in ("swiglu", "geglu"):
        act = F.silu if mlp_type == "swiglu" else gelu
        h = act((x @ params["w_gate"]).float()) * (x @ params["w_up"]).float()
    elif mlp_type == "relu2":  # nemotron squared-ReLU
        h = torch.relu((x @ params["w_up"]).float()) ** 2
    elif mlp_type == "gelu":
        h = gelu((x @ params["w_up"]).float())
    else:
        raise ValueError(mlp_type)
    return h.to(x.dtype) @ params["w_down"]


def mlp_init(gen: torch.Generator, d: int, f: int, mlp_type: str, dtype,
             device) -> Params:
    p = {}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (d, f), dtype, device)
    p["w_up"] = dense_init(gen, (d, f), dtype, device)
    p["w_down"] = dense_init(gen, (f, d), dtype, device)
    return p


# ---------------------------------------------------------------------------
# Losses (the reference's, without its mesh branches: vocab-parallel heads
# and the fsdp token chunk belong to training over a mesh)
# ---------------------------------------------------------------------------


def _largest_divisor_leq(n: int, target: int) -> int:
    target = max(1, min(n, target))
    for c in range(target, 0, -1):
        if n % c == 0:
            return c
    return 1


def _chunk_nll(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               softcap: float, z_loss: float) -> torch.Tensor:
    """Summed next-token NLL (+ z-loss) of one token chunk: h (B, sc, D)."""
    logits = h.float() @ head.float()                   # (B, sc, V) fp32
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, labels[..., None].long())[..., 0]
    if z_loss > 0.0:
        nll = nll + z_loss * lse ** 2
    return nll.sum()


def chunked_lm_loss(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, *, softcap: float = 0.0,
                    z_loss: float = 1e-4, token_chunk: int = 8192
                    ) -> torch.Tensor:
    """Token-mean cross-entropy (+ z-loss) from the final hidden states
    (B, T, D) without the whole (B, T, V) logits: the sequence is cut into
    chunks of ``sc`` tokens (the largest divisor of T up to
    ``token_chunk / B``), each chunk's fp32 logits formed inside a body
    checkpointed under grad mode, so the backward recomputes them too (the
    reference's ``jax.checkpoint`` over a ``lax.scan``)."""
    b, t, _ = hidden.shape
    sc = _largest_divisor_leq(t, max(1, token_chunk // max(b, 1)))
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, t, sc):
        args = (hidden[:, lo:lo + sc], head, labels[:, lo:lo + sc], softcap,
                z_loss)
        total = total + (checkpoint(_chunk_nll, *args, use_reentrant=False)
                         if remat else _chunk_nll(*args))
    return total / (b * t)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 1e-4,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross-entropy (+ z-loss) in fp32. logits (..., V)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    nll = lse - lf.gather(-1, labels[..., None].long())[..., 0]
    if z_loss > 0.0:
        nll = nll + z_loss * lse ** 2
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# Init helpers: the reference's shapes, scales and distributions (not its
# bits: torch cannot replay jax.random)
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape: Sequence[int], dtype, device,
           std: float = 1.0) -> torch.Tensor:
    t = torch.randn(tuple(shape), generator=gen, device=device)
    return (t * std).to(dtype)


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype, device,
               fan_in: Optional[int] = None) -> torch.Tensor:
    return normal(gen, shape, dtype, device, 1.0 / math.sqrt(fan_in or shape[0]))


def stack_layer_params(n: int, init_fn: Callable[[int], Params]) -> Params:
    """Initialize ``n`` layers and stack each leaf along a new leading axis
    (the reference's scan-over-layers layout).  The layers are drawn in
    order and each copied into a preallocated stack before the next is
    drawn, so the peak is the stack and one layer (not the layers twice)."""
    stack = None
    for i in range(n):
        layer = init_fn(i)
        if stack is None:
            stack = pytree.tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), layer)
        for dst, src in zip(pytree.tree_leaves(stack), pytree.tree_leaves(layer)):
            dst[i].copy_(src)
        del layer
    return stack


def unstack(tree: Params, n: int):
    """The ``n`` per-layer trees of a stacked parameter tree (views, no
    copy), each leaf unbound once along its layer axis."""
    parts = {key: unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for key, v in tree.items()}
    return [{key: part[i] for key, part in parts.items()} for i in range(n)]


def layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter tree (views, no copy)."""
    return {key: layer(v, i) if isinstance(v, dict) else v[i]
            for key, v in tree.items()}
