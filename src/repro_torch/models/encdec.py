"""Encoder-decoder transformer (the seamless-m4t-medium backbone), the port
of ``repro.models.encdec``.

The modality frontend is a stub, as in the reference: the caller supplies
precomputed speech-frame embeddings ``(B, T_enc, frontend_dim)``, which a
linear adapter projects to ``d_model``.  The encoder's layers are
bidirectional; the decoder's are causal self-attention, then cross-attention
over the encoder output, then the MLP.  RoPE acts on self-attention only.

Every attention is one ``flash_attention`` call (``common.attention``): the
encoder's and the cross-attention's with ``causal=False`` (cross-attention
with Tq != Tk), the decoder's causal; a decode step attends its KV cache
through ``common.decode_attention`` and, as the reference does, projects the
cached ``enc_out`` to cross-attention K and V again in every layer at every
step (one query against every encoder slot).

The layers are one stack per side (``enc_layers``, ``dec_layers``), as the
reference's scan keeps them; a forward unbinds each stacked leaf once (see
``hybrid.forward_hidden``), and with ``cfg.remat`` under grad mode each
layer is checkpointed, as the reference's ``jax.checkpoint`` of its body.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig

Params = cm.Params


# ---------------------------------------------------------------------------
# Init: the reference's tree, shapes, scales and distributions
# ---------------------------------------------------------------------------


def _attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": cm.dense_init(gen, (d, h * hd), dtype, device),
        "wk": cm.dense_init(gen, (d, hkv * hd), dtype, device),
        "wv": cm.dense_init(gen, (d, hkv * hd), dtype, device),
        "wo": cm.dense_init(gen, (h * hd, d), dtype, device, fan_in=h * hd),
    }


def _zeros(cfg: ModelConfig, dtype, device) -> torch.Tensor:
    return torch.zeros(cfg.d_model, dtype=dtype, device=device)


def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    return {"ln1": _zeros(cfg, dtype, device),
            "attn": _attn_init(gen, cfg, dtype, device),
            "ln2": _zeros(cfg, dtype, device),
            "mlp": cm.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, device)}


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    return {"ln1": _zeros(cfg, dtype, device),
            "self_attn": _attn_init(gen, cfg, dtype, device),
            "ln_cross": _zeros(cfg, dtype, device),
            "cross_attn": _attn_init(gen, cfg, dtype, device),
            "ln2": _zeros(cfg, dtype, device),
            "mlp": cm.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, device)}


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Drawn from ``gen`` on ``device``; the norms start at zero, as in the
    reference (so every layer adds nothing and the final norms output zero
    until they are trained or redrawn)."""
    dtype = cfg.activation_dtype
    return {
        "frontend_proj": cm.dense_init(gen, (cfg.frontend_dim, cfg.d_model), dtype,
                                       device),
        "embed": cm.normal(gen, (cfg.vocab_size, cfg.d_model), dtype, device, 0.02),
        "enc_layers": cm.stack_layer_params(
            cfg.enc_layers, lambda i: _enc_layer_init(gen, cfg, dtype, device)),
        "dec_layers": cm.stack_layer_params(
            cfg.dec_layers, lambda i: _dec_layer_init(gen, cfg, dtype, device)),
        "enc_norm": _zeros(cfg, dtype, device),
        "dec_norm": _zeros(cfg, dtype, device),
        "lm_head": cm.dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device),
    }


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, T, n·hd) -> its (B, n, T, hd) view."""
    return x.reshape(x.shape[0], x.shape[1], n, hd).transpose(1, 2)


def _mha(p: Params, xq: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig,
         env: cm.ShardEnv, causal: bool, rope: bool) -> torch.Tensor:
    """Attention of the queries of ``xq`` (B, Tq, D) over the keys and values
    of ``xkv`` (B, Tk, D): the products in the activation dtype, RoPE at
    positions 0.. on both sides when ``rope``."""
    tq = xq.shape[1]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = env.act_bhtd(env.split_heads(env.linear(xq, env.weight(p["wq"], 1)), h, hd))
    k = env.act_bhtd(env.split_heads(env.linear(xkv, env.weight(p["wk"], 1)), hkv, hd))
    v = env.act_bhtd(env.split_heads(env.linear(xkv, env.weight(p["wv"], 1)), hkv, hd))
    q, k, v = env.kernel_bhtd(q, k, v)
    if rope:
        q = cm.apply_rope(q, torch.arange(tq, device=xq.device), cfg.rope_theta)
        k = cm.apply_rope(k, torch.arange(xkv.shape[1], device=xq.device),
                          cfg.rope_theta)
    o = cm.attention(q, k, v, causal=causal, env=env)
    return env.out_proj(env.merge_heads(o), env.weight(p["wo"], 0))


def _enc_layer(p: Params, x: torch.Tensor, cfg: ModelConfig,
               env: cm.ShardEnv) -> torch.Tensor:
    h = cm.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = env.act_btd(x + _mha(p["attn"], h, h, cfg, env, causal=False, rope=True))
    h = cm.rms_norm(x, p["ln2"], cfg.norm_eps)
    return env.act_btd(x + cm.mlp_apply(p["mlp"], h, cfg.mlp_type, env))


def _dec_layer(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, env: cm.ShardEnv) -> torch.Tensor:
    h = cm.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = env.act_btd(x + _mha(p["self_attn"], h, h, cfg, env, causal=True,
                             rope=True))
    h = cm.rms_norm(x, p["ln_cross"], cfg.norm_eps)
    x = env.act_btd(x + _mha(p["cross_attn"], h, enc_out, cfg, env,
                             causal=False, rope=False))
    h = cm.rms_norm(x, p["ln2"], cfg.norm_eps)
    return env.act_btd(x + cm.mlp_apply(p["mlp"], h, cfg.mlp_type, env))


def _layers(layer_fn, stack: Params, n: int, cfg: ModelConfig, x: torch.Tensor,
            *extra) -> torch.Tensor:
    """``layer_fn(layer, x, *extra)`` over the ``n`` layers of ``stack``
    (each leaf unbound once), each checkpointed under grad mode with
    ``cfg.remat``."""
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in cm.unstack(stack, n):
        if remat:
            x = checkpoint(layer_fn, lp, x, *extra, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer_fn(lp, x, *extra)
    return x


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
           env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    """frames (B, T_enc, frontend_dim) -> encoder states (B, T_enc, D) in the
    activation dtype."""
    x = env.act_btd(env.linear(frames.to(cfg.activation_dtype), params["frontend_proj"]))
    x = _layers(_enc_layer, params["enc_layers"], cfg.enc_layers, cfg, x, cfg, env)
    return cm.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def decode_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  enc_out: torch.Tensor, env: cm.ShardEnv = cm.NO_SHARD
                  ) -> torch.Tensor:
    """tokens (B, S) over ``enc_out`` -> the decoder's final hidden states."""
    x = env.act_btd(cm.embed(params["embed"], tokens, env))
    x = _layers(_dec_layer, params["dec_layers"], cfg.dec_layers, cfg, x, enc_out,
                cfg, env)
    return cm.rms_norm(x, params["dec_norm"], cfg.norm_eps)


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   patches: Optional[torch.Tensor] = None,
                   env: cm.ShardEnv = cm.NO_SHARD) -> Tuple[torch.Tensor, float]:
    """(the decoder's final hidden states, aux 0.0); ``patches`` are the
    encoder frames."""
    if patches is None:
        raise ValueError("encdec needs encoder frames (patches)")
    return decode_hidden(params, cfg, tokens, encode(params, cfg, patches, env),
                         env), 0.0


def _logits(params: Params, x: torch.Tensor,
            env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    return env.linear(x.float(), params["lm_head"].float())


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None,
            env: cm.ShardEnv = cm.NO_SHARD):
    """tokens (B, S), frames ``patches`` (B, T_enc, F) -> (logits (B, S, V)
    f32, aux)."""
    x, aux = forward_hidden(params, cfg, tokens, patches, env)
    return env.act_btv(_logits(params, x, env)), aux


def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, patches: Optional[torch.Tensor] = None,
            env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    """Next-token cross-entropy (+ z-loss) of the decoder over the frames."""
    hidden, _ = forward_hidden(params, cfg, tokens, patches, env)
    return cm.chunked_lm_loss(hidden, params["lm_head"], labels, env=env,
                              vocab_parallel=env.vocab_parallel)


# ---------------------------------------------------------------------------
# Serving: the encoder runs once (its output lives in the cache); the
# decoder steps
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               enc_len: Optional[int] = None) -> Params:
    """``enc_out`` (B, enc_len, D) (default ``max_len`` slots; the caller
    writes ``encode``'s output there) and the decoder's stacked self-attention
    K and V caches (L, B, Hkv, max_len, hd)."""
    dtype = cfg.activation_dtype
    shape = (cfg.dec_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {
        "enc_out": torch.zeros((batch, enc_len or max_len, cfg.d_model), dtype=dtype,
                               device=device),
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": 0,
    }


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, env: cm.ShardEnv = cm.NO_SHARD):
    """One token for every sequence: tokens (B, 1) -> (logits (B, 1, V) f32,
    cache).  Writes the token's K and V into ``cache`` in place (the
    reference returns a new one) and returns it."""
    b = tokens.shape[0]
    pos = cache["pos"]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    enc_out = cache["enc_out"]
    x = cm.embed(params["embed"], tokens, env)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for i, p in enumerate(cm.unstack(params["dec_layers"], cfg.dec_layers)):
        sa = p["self_attn"]
        hh = cm.rms_norm(x, p["ln1"], cfg.norm_eps)
        q = cm.apply_rope(_heads(hh @ sa["wq"], h, hd), posv, cfg.rope_theta)
        kk = cm.apply_rope(_heads(hh @ sa["wk"], hkv, hd), posv, cfg.rope_theta)
        kc, vc = cache["k"][i], cache["v"][i]
        cm.write(kc, (slice(None), slice(None), pos), kk[:, :, 0])
        cm.write(vc, (slice(None), slice(None), pos), _heads(hh @ sa["wv"], hkv, hd)[:, :, 0])
        o = cm.decode_attention(q, kc, vc, pos + 1, env=env)
        x = x + o.transpose(1, 2).reshape(b, 1, h * hd) @ sa["wo"]
        hh = cm.rms_norm(x, p["ln_cross"], cfg.norm_eps)
        # the reference passes NO_SHARD here (no layout constraints); over a
        # mesh the port needs the env to run the kernel on local shards
        x = x + _mha(p["cross_attn"], hh, enc_out, cfg, env, causal=False, rope=False)
        hh = cm.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + cm.mlp_apply(p["mlp"], hh, cfg.mlp_type, env)
    cache["pos"] = pos + 1
    x = cm.rms_norm(x, params["dec_norm"], cfg.norm_eps)
    return _logits(params, x, env), cache
