"""Unified decoder-only transformer, the port of
``repro.models.transformer`` for the dense, MoE and VLM families (gemma2,
qwen, nemotron, yi, mixtral, grok, llava) and the hybrid's shared block.

Features selected per ``ModelConfig``: GQA, RoPE, sliding windows, the
gemma2 local/global alternation with sandwich norms and logit soft-caps,
QKV bias (qwen), squared-ReLU (nemotron), MoE layers in place of the MLP
(``n_experts > 0``: mixtral, grok; ``models/moe.py``), the vision-patch
prefix (llava).

The layers are stacked per group sub-layer, as the reference's scan over
layer groups keeps them (gemma2's group is [local, global]; every other
arch has a single-layer group); the scan is a Python loop here.  With
``cfg.remat`` under grad mode each group is checkpointed, as the reference's
``jax.checkpoint`` of its group body.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig

Params = cm.Params


# ---------------------------------------------------------------------------
# Layer groups: the repeating unit of the reference's scan
# ---------------------------------------------------------------------------


def group_size(cfg: ModelConfig) -> int:
    return cfg.local_global_period if cfg.local_global_period > 0 else 1


def n_groups(cfg: ModelConfig) -> int:
    g = group_size(cfg)
    if cfg.n_layers % g:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into "
                         f"groups of {g}")
    return cfg.n_layers // g


def sublayer_window(cfg: ModelConfig, sub_idx: int) -> int:
    """Sliding window for sub-layer ``sub_idx`` of a group (0 = full
    attention): under a local/global alternation the last sub-layer of each
    group is global."""
    if cfg.local_global_period > 0:
        is_global = sub_idx == cfg.local_global_period - 1
        return 0 if is_global else cfg.attn_window
    return cfg.attn_window


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


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
    """One layer: ``moe`` in place of ``mlp`` when ``n_experts > 0``."""
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dtype, device=device)  # noqa: E731
    p: Params = {"ln1": zeros(), "attn": _attn_init(gen, cfg, dtype, device),
                 "ln2": zeros()}
    if cfg.n_experts > 0:
        p["moe"] = moe.moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = cm.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype,
                               device)
    if cfg.local_global_period > 0:  # gemma2 sandwich norms
        p["ln1_post"] = zeros()
        p["ln2_post"] = zeros()
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """The reference's tree, shapes, scales and distributions, drawn from
    ``gen`` on ``device``: ``groups`` is a list of ``group_size`` stacks,
    each over ``n_groups`` layers; ``lm_head`` only when the embeddings are
    untied; ``mm_proj`` for the vision frontend.  Norms start at zero."""
    dtype = cfg.activation_dtype
    ng = n_groups(cfg)
    params: Params = {
        "embed": cm.normal(gen, (cfg.vocab_size, cfg.d_model), dtype, device, 0.02),
        "groups": [cm.stack_layer_params(ng, lambda i: _layer_init(gen, cfg, dtype, device))
                   for _ in range(group_size(cfg))],
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                          device)
    if cfg.frontend == "vision":
        params["mm_proj"] = {
            "w1": cm.dense_init(gen, (cfg.frontend_dim, cfg.d_model), dtype, device),
            "w2": cm.dense_init(gen, (cfg.d_model, cfg.d_model), dtype, device),
        }
    return params


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
         env: cm.ShardEnv = cm.NO_SHARD):
    """q (B, H, T, hd) and k, v (B, Hkv, T, hd) as views of the projections,
    each placed by ``env.act_bhtd``."""
    q, k, v = (env.linear(x, env.weight(p[w], 1)) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (env.act_bhtd(env.split_heads(q, cfg.n_heads, cfg.hd)),
            env.act_bhtd(env.split_heads(k, cfg.n_kv_heads, cfg.hd)),
            env.act_bhtd(env.split_heads(v, cfg.n_kv_heads, cfg.hd)))


def _attn_apply(p: Params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, window: int,
                env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    q, k, v = env.kernel_bhtd(*_qkv(p, x, cfg, env))
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    o = cm.attention(q, k, v, causal=True, window=window,
                     softcap=cfg.attn_softcap, env=env)
    return env.out_proj(env.merge_heads(o), env.weight(p["wo"], 0))


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig,
         env: cm.ShardEnv = cm.NO_SHARD):
    """The layer's MLP or MoE on the normed ``h``: (out, aux loss; 0.0 for
    an MLP)."""
    if cfg.n_experts > 0:
        return moe.moe_apply(p["moe"], h, cfg, env)
    return cm.mlp_apply(p["mlp"], h, cfg.mlp_type, env), 0.0


def _block_apply(p: Params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, window: int, env: cm.ShardEnv = cm.NO_SHARD):
    """One transformer block; returns (x, aux_loss)."""
    sandwich = cfg.local_global_period > 0
    h = cm.rms_norm(x, p["ln1"], cfg.norm_eps, plus_one=True)
    h = _attn_apply(p["attn"], h, positions, cfg, window, env)
    if sandwich:
        h = cm.rms_norm(h, p["ln1_post"], cfg.norm_eps, plus_one=True)
    x = env.act_btd(x + h)
    h, aux = _ffn(p, cm.rms_norm(x, p["ln2"], cfg.norm_eps, plus_one=True), cfg,
                  env)
    if sandwich:
        h = cm.rms_norm(h, p["ln2_post"], cfg.norm_eps, plus_one=True)
    return env.act_btd(x + h), aux


def embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 patches: Optional[torch.Tensor] = None,
                 env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    """Token embeddings (gemma's scaled by √d_model in fp32, then rounded),
    with the VLM patch prefix projected (GELU between the two products, on
    the fp32 product as the reference applies it) and prepended."""
    x = cm.embed(params["embed"], tokens, env)
    if cfg.local_global_period > 0:  # gemma-style embedding scaling
        x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
    if patches is not None:
        mm = params["mm_proj"]
        pe = cm.gelu(env.linear(patches.to(x.dtype).float(), mm["w1"].float()))
        x = torch.cat([env.linear(pe.to(x.dtype), mm["w2"]), x], dim=1)
    return env.act_btd(x)


def _group(layers: List[Params], cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor, env: cm.ShardEnv = cm.NO_SHARD):
    """One group: its sub-layers (per-layer trees) in order; returns (x, the
    sum of their aux losses)."""
    aux = 0.0
    for s, lp in enumerate(layers):
        x, a = _block_apply(lp, x, positions, cfg, sublayer_window(cfg, s), env)
        aux = aux + a
    return x, aux


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   patches: Optional[torch.Tensor] = None,
                   env: cm.ShardEnv = cm.NO_SHARD):
    """tokens (B, S) [+ patches (B, P, F)] -> (final hidden (B, T, D), aux):
    aux is the MoE load-balancing loss summed over the layers (an fp32
    scalar), 0.0 for a family without experts.  Each group sub-layer's
    stacked leaves are unbound once (see ``hybrid.forward_hidden``)."""
    x = embed_inputs(params, cfg, tokens, patches, env)
    positions = torch.arange(x.shape[1], device=x.device)
    ng = n_groups(cfg)
    stacks = [cm.unstack(stack, ng) for stack in params["groups"]]
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for i in range(ng):
        layers = [stack[i] for stack in stacks]
        if remat:
            x, a = checkpoint(_group, layers, cfg, x, positions, env,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _group(layers, cfg, x, positions, env)
        aux = aux + a
    return cm.rms_norm(x, params["final_norm"], cfg.norm_eps, plus_one=True), aux


def lm_head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
            env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    """fp32 logits of the final hidden states, soft-capped where the config
    says (in place when no gradient flows and no mesh places them:
    gemma2's are 8.4 GB at 8192 tokens)."""
    logits = env.linear(x.float(), lm_head(params, cfg).float())
    cap = cfg.final_softcap
    if cap <= 0.0:
        return logits
    if logits.requires_grad or env.mesh is not None:
        return cap * torch.tanh(logits / cap)
    return logits.div_(cap).tanh_().mul_(cap)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None,
            env: cm.ShardEnv = cm.NO_SHARD):
    """tokens (B, S) [+ patches (B, P, F)] -> (logits (B, T, V) f32, aux)."""
    x, aux = forward_hidden(params, cfg, tokens, patches, env)
    return env.act_btv(_logits(params, cfg, x, env)), aux


def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, patches: Optional[torch.Tensor] = None,
            env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    """Next-token cross-entropy (+ z-loss) over the text (the suffix after
    the patch prefix), soft-capped logits, + 0.01·aux."""
    hidden, aux = forward_hidden(params, cfg, tokens, patches, env)
    if patches is not None:
        hidden = hidden[:, patches.shape[1]:]
    loss = cm.chunked_lm_loss(hidden, lm_head(params, cfg), labels,
                              softcap=cfg.final_softcap, env=env,
                              vocab_parallel=env.vocab_parallel)
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode (serving): KV caches with rolling buffers for windowed layers
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    """Per group sub-layer stacked (n_groups, B, Hkv, Tc, hd) K and V caches;
    a windowed sub-layer's is a rolling buffer of min(window, max_len)
    slots."""
    dtype = cfg.activation_dtype
    layers = []
    for s in range(group_size(cfg)):
        win = sublayer_window(cfg, s)
        tc = min(win, max_len) if win > 0 else max_len
        shape = (n_groups(cfg), batch, cfg.n_kv_heads, tc, cfg.hd)
        layers.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)})
    return {"layers": layers, "pos": 0}


def decode_block(p: Params, x: torch.Tensor, kc: torch.Tensor,
                 vc: torch.Tensor, pos: int, cfg: ModelConfig, win: int,
                 env: cm.ShardEnv = cm.NO_SHARD
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
    q, kk, vv = _qkv(p["attn"], hh, cfg, env)
    posv = torch.full((1,), pos, dtype=torch.int32, device=kk.device)
    q = cm.apply_rope(q, posv, cfg.rope_theta)
    kk = cm.apply_rope(kk, posv, cfg.rope_theta)
    slot = pos % tc if rolling else min(pos, tc - 1)
    cm.write(kc, (slice(None), slice(None), slot), kk[:, :, 0])
    cm.write(vc, (slice(None), slice(None), slot), vv[:, :, 0])
    o = cm.decode_attention(q, kc, vc, pos + 1, softcap=cfg.attn_softcap,
                            rolling=rolling, env=env)
    attn_out = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
    if sandwich:
        attn_out = cm.rms_norm(attn_out, p["ln1_post"], cfg.norm_eps,
                               plus_one=True)
    x = x + attn_out
    mlp_out, _ = _ffn(p, cm.rms_norm(x, p["ln2"], cfg.norm_eps, plus_one=True), cfg,
                      env)
    if sandwich:
        mlp_out = cm.rms_norm(mlp_out, p["ln2_post"], cfg.norm_eps,
                              plus_one=True)
    return x + mlp_out, kc, vc


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, env: cm.ShardEnv = cm.NO_SHARD):
    """One token for every sequence: tokens (B, 1) -> (logits (B, 1, V) f32,
    cache).  Updates ``cache`` in place (the reference returns a new one)
    and returns it."""
    pos = cache["pos"]
    x = cm.embed(params["embed"], tokens, env)
    if cfg.local_global_period > 0:
        x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
    for i in range(n_groups(cfg)):
        for s, (stack, kv) in enumerate(zip(params["groups"], cache["layers"])):
            x, _, _ = decode_block(cm.layer(stack, i), x, kv["k"][i], kv["v"][i], pos,
                                   cfg, sublayer_window(cfg, s), env)
    cache["pos"] = pos + 1
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps, plus_one=True)
    return _logits(params, cfg, x, env), cache
