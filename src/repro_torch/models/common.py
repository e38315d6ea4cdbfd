"""Shared model building blocks, the parts of ``repro.models.common`` that the
hybrid uses: norms, RoPE, attention through the fused kernel, MLPs and init
helpers.

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
    tiles the masks hide."""
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


def mlp_apply(params: Params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type in ("swiglu", "geglu"):
        act = F.silu if mlp_type == "swiglu" else F.gelu
        h = act((x @ params["w_gate"]).float()) * (x @ params["w_up"]).float()
    elif mlp_type == "relu2":  # nemotron squared-ReLU
        h = torch.relu((x @ params["w_up"]).float()) ** 2
    elif mlp_type == "gelu":
        h = F.gelu((x @ params["w_up"]).float())
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
    (the reference's scan-over-layers layout)."""
    return _stack([init_fn(i) for i in range(n)])


def _stack(trees) -> Params:
    return {key: (_stack([t[key] for t in trees]) if isinstance(trees[0][key], dict)
                  else torch.stack([t[key] for t in trees]))
            for key in trees[0]}


def layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter tree (views, no copy)."""
    return {key: layer(v, i) if isinstance(v, dict) else v[i]
            for key, v in tree.items()}
