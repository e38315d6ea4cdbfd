"""Zamba2-style hybrid, the port of ``repro.models.hybrid`` for inference:
``n_layers`` Mamba-2 blocks and, after every ``share_period`` of them, ONE
shared transformer block (the same parameters every application).  The
reference's ``lax.scan`` over the stacked layer axis is a Python loop here;
the shared block's KV caches are per application (stacked on the first
axis).
"""

from __future__ import annotations

import torch

from repro_torch.models import common as cm
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

Params = cm.Params


def n_apps(cfg: ModelConfig) -> int:
    if cfg.share_period <= 0 or cfg.n_layers % cfg.share_period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into "
                         f"groups of share_period={cfg.share_period}")
    return cfg.n_layers // cfg.share_period


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """The reference's shapes, scales and distributions, drawn from ``gen``
    on ``device``: norms start at zero, as in the reference."""
    dtype = cfg.activation_dtype
    return {
        "embed": cm.normal(gen, (cfg.vocab_size, cfg.d_model), dtype, device, 0.02),
        "layers": cm.stack_layer_params(
            cfg.n_layers, lambda i: ssm.mamba_init(gen, cfg, dtype, device)),
        "shared": tf._layer_init(gen, cfg, dtype, device),
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=device),
        "lm_head": cm.dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device),
    }


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens (B, T) -> (final hidden states (B, T, D) in the activation
    dtype, aux 0.0)."""
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(cfg.n_layers):
        x, _ = ssm.mamba_apply(cm.layer(params["layers"], i), x, cfg)
        if (i + 1) % cfg.share_period == 0:
            x, _ = tf._block_apply(params["shared"], x, positions, cfg,
                                   cfg.attn_window)
    return cm.rms_norm(x, params["final_norm"], cfg.norm_eps), 0.0


def _logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ params["lm_head"].float()


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens (B, T) -> (logits (B, T, V) f32, aux 0.0)."""
    x, aux = forward_hidden(params, cfg, tokens)
    return _logits(params, x), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    dtype = cfg.activation_dtype
    dinner, s, g = cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_ngroups
    L, na = cfg.n_layers, n_apps(cfg)
    kv = (na, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, dinner + 2 * g * s),
                            dtype=dtype, device=device),
        "h": torch.zeros((L, batch, cfg.ssm_heads, s, cfg.ssm_headdim),
                         dtype=torch.float32, device=device),
        "attn_k": torch.zeros(kv, dtype=dtype, device=device),
        "attn_v": torch.zeros(kv, dtype=dtype, device=device),
        "pos": 0,
    }


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, 1, V) f32, cache).  Updates ``cache`` in
    place (the reference returns a new one) and returns it."""
    x = params["embed"][tokens]
    pos = cache["pos"]
    for i in range(cfg.n_layers):
        x, st = ssm.mamba_apply(cm.layer(params["layers"], i), x, cfg,
                                state={"conv": cache["conv"][i], "h": cache["h"][i]},
                                single_step=True)
        cache["conv"][i] = st["conv"]
        cache["h"][i] = st["h"]
        if (i + 1) % cfg.share_period == 0:
            app = i // cfg.share_period
            x, _, _ = tf.decode_block(params["shared"], x, cache["attn_k"][app],
                                      cache["attn_v"][app], pos, cfg,
                                      cfg.attn_window)
    cache["pos"] = pos + 1
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x), cache
