"""Mamba-2 block, the parts of ``repro.models.ssm`` that the hybrid uses.

The full-sequence branch runs the SSD through ``kernels.ssd.ops.ssd_scan``
(the CUDA chunk kernel on the card) in fp32, as the reference's
``ssd_chunked`` casts to fp32; the one-token decode branch is torch ops.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig

Params = cm.Params


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    dinner, s, g, h = cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_heads
    conv_dim = dinner + 2 * g * s
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": torch.zeros(d, dtype=dtype, device=device),
        "in_proj": cm.dense_init(gen, (d, 2 * dinner + 2 * g * s + h), dtype, device),
        "conv_w": cm.normal(gen, (cfg.ssm_conv, conv_dim), dtype, device,
                            1.0 / math.sqrt(cfg.ssm_conv)),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "dt_bias": torch.zeros(h, **f32),
        "d_skip": torch.ones(h, **f32),
        "gate_norm": torch.zeros(dinner, dtype=dtype, device=device),
        "out_proj": cm.dense_init(gen, (dinner, d), dtype, device, fan_in=dinner),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along T. x (B,T,C), w (K,C). Returns (y, new
    state (B,K-1,C)) where the state carries the last K-1 inputs."""
    k, t = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xx = torch.cat([state, x], dim=1)                      # (B, T+K-1, C)
    out = xx[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + xx[:, i:i + t] * w[i]
    new_state = xx[:, -(k - 1):] if k > 1 else state
    return out + b, new_state


def mamba_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Params] = None, single_step: bool = False
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B,T,D) -> (y (B,T,D), new_state).  ``state`` carries
    {"conv": (B,K-1,C), "h": (B,H,S,P)} for decode."""
    b, t, _ = x.shape
    dinner, s, g, h = cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_heads
    pdim = cfg.ssm_headdim
    res = x
    proj = cm.rms_norm(x, p["norm"], cfg.norm_eps) @ p["in_proj"]
    z, xbc, dt = proj.split([dinner, dinner + 2 * g * s, h], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 state["conv"] if state is not None else None)
    xbc = F.silu(xbc)
    xs, bmat, cmat = xbc.split([dinner, g * s, g * s], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])             # (B,T,H)
    a = -torch.exp(p["a_log"])                              # (H,)
    xh = xs.reshape(b, t, h, pdim)

    if single_step:
        hpg = h // g
        dt1 = dt[:, 0]                                      # (B,H)
        bg = bmat[:, 0].reshape(b, g, s).repeat_interleave(hpg, dim=1).float()
        cg = cmat[:, 0].reshape(b, g, s).repeat_interleave(hpg, dim=1).float()
        h_fin = (torch.exp(a * dt1)[..., None, None] * state["h"]
                 + dt1[..., None, None] * bg[..., None]
                 * xh[:, 0].float()[:, :, None, :])
        y = torch.einsum("bhs,bhsp->bhp", cg, h_fin)[:, None].to(x.dtype)
    else:
        # (B,T,H,P) -> ssd_scan's (B·H, T, P); B and C stay per group
        bg = lambda m: m.reshape(b, t, g, s).transpose(1, 2).reshape(b * g, t, s).float()  # noqa: E731
        h0 = state["h"].reshape(b * h, s, pdim) if state is not None else None
        y, h_fin = ssd_scan(xh.float().transpose(1, 2).reshape(b * h, t, pdim),
                            dt.transpose(1, 2).reshape(b * h, t), a.repeat(b),
                            bg(bmat), bg(cmat), h0, chunk=cfg.ssm_chunk)
        y = y.reshape(b, h, t, pdim).transpose(1, 2).to(x.dtype)
        h_fin = h_fin.reshape(b, h, s, pdim)

    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(b, t, dinner).to(x.dtype)
    y = cm.rms_norm(y * F.silu(z.float()).to(x.dtype), p["gate_norm"], cfg.norm_eps)
    new_state = ({"conv": new_conv, "h": h_fin}
                 if state is not None or single_step else None)
    return res + y @ p["out_proj"], new_state
