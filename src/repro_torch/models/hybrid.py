"""Zamba2-style hybrid, the port of ``repro.models.hybrid``: ``n_layers``
Mamba-2 blocks and, after every ``share_period`` of them, ONE shared
transformer block (the same parameters every application).  The
reference's ``lax.scan`` over the stacked layer axis is a Python loop here;
the shared block's KV caches are per application (stacked on the first
axis).  Training takes ``loss_fn``; with ``cfg.remat`` each group of
``share_period`` Mamba layers and the shared block is checkpointed, as the
reference's ``jax.checkpoint`` of its group body.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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


def _group(layers, shared: Params, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor, env: cm.ShardEnv = cm.NO_SHARD
           ) -> torch.Tensor:
    """One group: the Mamba layers ``layers`` (per-layer trees) and the
    shared block."""
    for lp in layers:
        x, _ = ssm.mamba_apply(lp, x, cfg, env)
    x, _ = tf._block_apply(shared, x, positions, cfg, cfg.attn_window, env)
    return x


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   env: cm.ShardEnv = cm.NO_SHARD):
    """tokens (B, T) -> (final hidden states (B, T, D) in the activation
    dtype, aux 0.0).  Under grad mode with ``cfg.remat`` each group keeps
    only its input for the backward and runs again there (its kernels
    launch twice a step); without grad it is a plain loop.  The stacked
    layer leaves are unbound once, so the backward stacks each leaf's
    per-layer gradients once (indexing a layer per call would write a
    full-size gradient of the stack per layer)."""
    x = env.act_btd(cm.embed(params["embed"], tokens, env))
    positions = torch.arange(tokens.shape[1], device=x.device)
    layers = cm.unstack(params["layers"], cfg.n_layers)
    remat = cfg.remat and torch.is_grad_enabled()
    per = cfg.share_period
    for g in range(n_apps(cfg)):
        group = layers[g * per:(g + 1) * per]
        if remat:
            x = checkpoint(_group, group, params["shared"], cfg, x, positions,
                           env, use_reentrant=False, preserve_rng_state=False)
        else:
            x = _group(group, params["shared"], cfg, x, positions, env)
    return cm.rms_norm(x, params["final_norm"], cfg.norm_eps), 0.0


def _logits(params: Params, x: torch.Tensor,
            env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    return env.linear(x.float(), params["lm_head"].float())


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            patches=None, env: cm.ShardEnv = cm.NO_SHARD):
    """tokens (B, T) -> (logits (B, T, V) f32, aux 0.0)."""
    del patches
    x, aux = forward_hidden(params, cfg, tokens, env)
    return env.act_btv(_logits(params, x, env)), aux


def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, patches=None,
            env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    """Next-token cross-entropy (+ z-loss), token mean, fp32 scalar."""
    del patches
    hidden, _ = forward_hidden(params, cfg, tokens, env)
    return cm.chunked_lm_loss(hidden, params["lm_head"], labels, env=env,
                              vocab_parallel=env.vocab_parallel)


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
                tokens: torch.Tensor, env: cm.ShardEnv = cm.NO_SHARD):
    """tokens (B, 1) -> (logits (B, 1, V) f32, cache).  Updates ``cache`` in
    place (the reference returns a new one) and returns it."""
    x = cm.embed(params["embed"], tokens, env)
    pos = cache["pos"]
    for i in range(cfg.n_layers):
        x, st = ssm.mamba_apply(cm.layer(params["layers"], i), x, cfg, env,
                                state={"conv": cache["conv"][i], "h": cache["h"][i]},
                                single_step=True)
        cm.write(cache["conv"], (i,), st["conv"])
        cm.write(cache["h"], (i,), st["h"])
        if (i + 1) % cfg.share_period == 0:
            app = i // cfg.share_period
            x, _, _ = tf.decode_block(params["shared"], x, cache["attn_k"][app],
                                      cache["attn_v"][app], pos, cfg,
                                      cfg.attn_window, env)
    cache["pos"] = pos + 1
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, env), cache
