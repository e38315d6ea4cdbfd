"""Mamba-2 (SSD), the port of ``repro.models.ssm``: the block the hybrid
uses and the attention-free language model (mamba2-370m).

The full-sequence branch runs the SSD through ``kernels.ssd.ops.ssd_scan``
(the CUDA chunk kernel on the card) in fp32, as the reference's
``ssd_chunked`` casts to fp32; the one-token decode branch is torch ops.
The reference's ``lax.scan`` over the stacked layers is a Python loop;
with ``cfg.remat`` under grad mode each layer is checkpointed, as its
``jax.checkpoint`` of the scan body.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import Spec
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


def _batch_lead(env: cm.ShardEnv, batch: int, *ts):
    """``ts`` with the leading dim over the batch axes and every other dim
    whole (every dim whole when the batch axes do not divide ``batch``):
    the layout the SSD takes, in which B·H and B·G shard alike."""
    if env.mesh is None:
        return ts
    lead = env.batch_axes if batch % env._axis_size(env.batch_axes) == 0 else None
    return tuple(env.constrain(t, Spec(lead, *([None] * (t.ndim - 1)))) for t in ts)


def _ssd(env: cm.ShardEnv, batch: int, chunk: int, x, dt, a, b, c, h0=None):
    """``ssd_scan`` on (B·H, ...) tensors; over a mesh on each rank's shard
    of B·H, split along the batch (T is never split): B and C are per
    (batch, group), so B·H and B·G shard alike only at batch boundaries."""
    fn = lambda *t: ssd_scan(*t, chunk=chunk)  # noqa: E731
    args = (x, dt, a, b, c) if h0 is None else (x, dt, a, b, c, h0)
    return cm.kernel_call(fn, (0, 0), *_batch_lead(env, batch, *args))


def mamba_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                env: cm.ShardEnv = cm.NO_SHARD,
                state: Optional[Params] = None, single_step: bool = False
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B,T,D) -> (y (B,T,D), new_state).  ``state`` carries
    {"conv": (B,K-1,C), "h": (B,H,S,P)} for decode."""
    b, t, _ = x.shape
    dinner, s, g, h = cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_heads
    pdim = cfg.ssm_headdim
    res = x
    proj = env.linear(cm.rms_norm(x, p["norm"], cfg.norm_eps), env.weight(p["in_proj"], 1))
    z, xbc, dt = proj.split([dinner, dinner + 2 * g * s, h], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 state["conv"] if state is not None else None)
    xbc = F.silu(xbc)
    xs, bmat, cmat = xbc.split([dinner, g * s, g * s], dim=-1)
    xs = env.act_btf(xs) if dinner == cfg.d_ff else xs
    dt = F.softplus(dt.float() + p["dt_bias"])             # (B,T,H)
    a = -torch.exp(p["a_log"])                              # (H,)
    uneven = env.mesh is not None and h % env._axis_size(env.tp)
    if uneven:                  # h heads cannot be cut from a tp-sharded dim
        xs = cm.whole_dim(xs, 2)
    if env.mesh is not None and g % env._axis_size(env.tp):
        bmat, cmat = cm.whole_dim(bmat, 2), cm.whole_dim(cmat, 2)
    xh = xs.reshape(b, t, h, pdim)

    if single_step:
        hpg = h // g
        dt1 = dt[:, 0]                                      # (B,H)
        bg = bmat[:, 0].reshape(b, g, s).repeat_interleave(hpg, dim=1).float()
        cg = cmat[:, 0].reshape(b, g, s).repeat_interleave(hpg, dim=1).float()
        h_fin = (torch.exp(a * dt1)[..., None, None] * state["h"]
                 + dt1[..., None, None] * bg[..., None]
                 * xh[:, 0].float()[:, :, None, :])
        # over a mesh on local shards, C placed as the state is: torch
        # 2.11's DTensor refuses the einsum's flatten of a sharded (B, H)
        if env.mesh is not None:
            cg = cg.redistribute(h_fin.device_mesh, h_fin.placements)
        y = cm.kernel_call(lambda c, hs: torch.einsum("bhs,bhsp->bhp", c, hs),
                           1, cg, h_fin)[:, None].to(x.dtype)
    else:
        # placed by batch before (B,T,H,P) -> ssd_scan's (B·H, T, P): a
        # flatten may shard only its leading dim; B and C stay per group
        xh, dt, bmat, cmat = _batch_lead(env, b, xh, dt, bmat, cmat)
        bg = lambda m: m.reshape(b, t, g, s).transpose(1, 2).reshape(b * g, t, s).float()  # noqa: E731
        h0 = state["h"].reshape(b * h, s, pdim) if state is not None else None
        y, h_fin = _ssd(env, b, cfg.ssm_chunk,
                        xh.float().transpose(1, 2).reshape(b * h, t, pdim),
                        dt.transpose(1, 2).reshape(b * h, t), a.repeat(b),
                        bg(bmat), bg(cmat), h0)
        y = cm.anchor(y.reshape(b, h, t, pdim)).transpose(1, 2).to(x.dtype)
        h_fin = h_fin.reshape(b, h, s, pdim)

    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(b, t, dinner).to(x.dtype)
    if uneven:                  # its gradient back with the heads whole
        y = cm.anchor(y)
    y = cm.rms_norm(y * F.silu(z.float()).to(x.dtype), p["gate_norm"], cfg.norm_eps)
    new_state = ({"conv": new_conv, "h": h_fin}
                 if state is not None or single_step else None)
    return env.act_btd(res + env.out_proj(y, env.weight(p["out_proj"], 0))), new_state


# ---------------------------------------------------------------------------
# Mamba-2 LM
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """The reference's tree, shapes, scales and distributions, drawn from
    ``gen`` on ``device``: norms start at zero, as in the reference; the
    logits come from the tied embedding."""
    dtype = cfg.activation_dtype
    return {
        "embed": cm.normal(gen, (cfg.vocab_size, cfg.d_model), dtype, device, 0.02),
        "layers": cm.stack_layer_params(
            cfg.n_layers, lambda i: mamba_init(gen, cfg, dtype, device)),
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=device),
    }


def _layer(lp: Params, cfg: ModelConfig, x: torch.Tensor,
           env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    return mamba_apply(lp, x, cfg, env)[0]


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   patches=None, env: cm.ShardEnv = cm.NO_SHARD):
    """tokens (B, T) -> (final hidden states (B, T, D), aux 0.0).  The final
    norm has no ``plus_one``.  The stacked leaves are unbound once (see
    ``hybrid.forward_hidden``)."""
    del patches
    x = env.act_btd(cm.embed(params["embed"], tokens, env))
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in cm.unstack(params["layers"], cfg.n_layers):
        if remat:
            x = checkpoint(_layer, lp, cfg, x, env, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _layer(lp, cfg, x, env)
    return cm.rms_norm(x, params["final_norm"], cfg.norm_eps), 0.0


def _logits(params: Params, x: torch.Tensor,
            env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    return env.linear(x.float(), params["embed"].float().T)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            patches=None, env: cm.ShardEnv = cm.NO_SHARD):
    """tokens (B, T) -> (logits (B, T, V) f32, aux 0.0)."""
    x, aux = forward_hidden(params, cfg, tokens, patches, env)
    return env.act_btv(_logits(params, x, env)), aux


def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, patches=None,
            env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    """Next-token cross-entropy (+ z-loss), token mean, fp32 scalar."""
    hidden, _ = forward_hidden(params, cfg, tokens, env=env)
    return cm.chunked_lm_loss(hidden, params["embed"].T, labels, env=env,
                              vocab_parallel=env.vocab_parallel)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    """Per layer the conv window (B, K-1, C) and the SSD state (B, H, S, P)
    f32: O(1) in the sequence length, so ``max_len`` is unused."""
    del max_len
    dinner, s, g = cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_ngroups
    L = cfg.n_layers
    return {
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, dinner + 2 * g * s),
                            dtype=cfg.activation_dtype, device=device),
        "h": torch.zeros((L, batch, cfg.ssm_heads, s, cfg.ssm_headdim),
                         dtype=torch.float32, device=device),
        "pos": 0,
    }


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, env: cm.ShardEnv = cm.NO_SHARD):
    """tokens (B, 1) -> (logits (B, 1, V) f32, cache).  Updates ``cache`` in
    place (the reference returns a new one) and returns it."""
    x = cm.embed(params["embed"], tokens, env)
    for i in range(cfg.n_layers):
        x, st = mamba_apply(cm.layer(params["layers"], i), x, cfg, env,
                            state={"conv": cache["conv"][i], "h": cache["h"][i]},
                            single_step=True)
        cm.write(cache["conv"], (i,), st["conv"])
        cm.write(cache["h"], (i,), st["h"])
    cache["pos"] += 1
    return _logits(params, cm.rms_norm(x, params["final_norm"], cfg.norm_eps), env), cache
