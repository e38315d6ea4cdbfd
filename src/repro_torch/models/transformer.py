"""Transformer blocks, the parts of ``repro.models.transformer`` that the
hybrid's shared block uses: init, the full-sequence block and the one-token
decode block, with GQA, RoPE, sliding windows, soft-caps, QKV bias and the
gemma2 sandwich norms.  MoE layers are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig

Params = cm.Params


def _attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": cm.dense_init(gen, (d, h * hd), dtype, device),
        "wk": cm.dense_init(gen, (d, hkv * hd), dtype, device),
        "wv": cm.dense_init(gen, (d, hkv * hd), dtype, device),
        "wo": cm.dense_init(gen, (h * hd, d), dtype, device, fan_in=h * hd),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros(width, dtype=dtype, device=device)
    return p


def _layer_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    if cfg.n_experts > 0:
        raise KeyError("MoE layers are not ported to repro_torch yet "
                       "(see ROADMAP.md)")
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dtype, device=device)  # noqa: E731
    p: Params = {"ln1": zeros(), "attn": _attn_init(gen, cfg, dtype, device),
                 "ln2": zeros(),
                 "mlp": cm.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                                    dtype, device)}
    if cfg.local_global_period > 0:  # gemma2 sandwich norms
        p["ln1_post"] = zeros()
        p["ln2_post"] = zeros()
    return p


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """q (B, H, T, hd) and k, v (B, Hkv, T, hd) as views of the projections."""
    b, t, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, t, cfg.n_heads, cfg.hd).transpose(1, 2),
            k.reshape(b, t, cfg.n_kv_heads, cfg.hd).transpose(1, 2),
            v.reshape(b, t, cfg.n_kv_heads, cfg.hd).transpose(1, 2))


def _attn_apply(p: Params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, window: int) -> torch.Tensor:
    b, t, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    o = cm.attention(q, k, v, causal=True, window=window,
                     softcap=cfg.attn_softcap)
    return o.transpose(1, 2).reshape(b, t, cfg.n_heads * cfg.hd) @ p["wo"]


def _block_apply(p: Params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, window: int) -> Tuple[torch.Tensor, float]:
    """One transformer block; returns (x, aux_loss)."""
    sandwich = cfg.local_global_period > 0
    h = cm.rms_norm(x, p["ln1"], cfg.norm_eps, plus_one=True)
    h = _attn_apply(p["attn"], h, positions, cfg, window)
    if sandwich:
        h = cm.rms_norm(h, p["ln1_post"], cfg.norm_eps, plus_one=True)
    x = x + h
    h = cm.mlp_apply(p["mlp"], cm.rms_norm(x, p["ln2"], cfg.norm_eps,
                                           plus_one=True), cfg.mlp_type)
    if sandwich:
        h = cm.rms_norm(h, p["ln2_post"], cfg.norm_eps, plus_one=True)
    return x + h, 0.0


def decode_block(p: Params, x: torch.Tensor, kc: torch.Tensor,
                 vc: torch.Tensor, pos: int, cfg: ModelConfig, win: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One transformer block for a single decode token at position ``pos``.
    Writes the token's K and V into the caches ``kc``/``vc`` (B, Hkv, Tc, hd)
    in place (the reference returns updated copies) and returns
    (x, kc, vc).  ``win > 0`` caches are rolling buffers."""
    b = x.shape[0]
    rolling = win > 0
    tc = kc.shape[2]
    sandwich = cfg.local_global_period > 0
    hh = cm.rms_norm(x, p["ln1"], cfg.norm_eps, plus_one=True)
    q, kk, vv = _qkv(p["attn"], hh, cfg)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = cm.apply_rope(q, posv, cfg.rope_theta)
    kk = cm.apply_rope(kk, posv, cfg.rope_theta)
    slot = pos % tc if rolling else min(pos, tc - 1)
    kc[:, :, slot] = kk[:, :, 0]
    vc[:, :, slot] = vv[:, :, 0]
    o = cm.decode_attention(q, kc, vc, pos + 1, softcap=cfg.attn_softcap,
                            rolling=rolling)
    attn_out = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
    if sandwich:
        attn_out = cm.rms_norm(attn_out, p["ln1_post"], cfg.norm_eps,
                               plus_one=True)
    x = x + attn_out
    mlp_out = cm.mlp_apply(p["mlp"], cm.rms_norm(x, p["ln2"], cfg.norm_eps,
                                                 plus_one=True), cfg.mlp_type)
    if sandwich:
        mlp_out = cm.rms_norm(mlp_out, p["ln2_post"], cfg.norm_eps,
                              plus_one=True)
    return x + mlp_out, kc, vc
