"""Mixture-of-Experts layer (mixtral / grok-1), the port of
``repro.models.moe``: top-k routing with capacity buffers and batched
expert GEMMs.

Dispatch, with static buffer shapes as the reference's, local to each
data-parallel shard: the tokens are reshaped to ``(ds, n/ds, D)`` with
``ds = _dp_size(env)`` shards over the batch axes (1 without a mesh), and

1. router logits in fp32 -> ``torch.topk`` (k experts per token, descending,
   the combine weights a softmax over the k),
2. each slot's position in its expert: an exclusive cumsum of the one-hot
   over the shard's token-major (token, choice) slots, so the later tokens'
   slots are the ones past capacity (``routing``),
3. the kept slots written into per-expert capacity buffers (ds, E, C, D);
   slots past capacity are DROPPED (GShard-style; ``capacity_factor`` sets
   the drop rate; a busy shard drops locally, so a mesh's drops differ
   from one device's),
4. the expert GEMMs ``(ds, E, C, D) x (E, D, F)`` (the reference's einsums,
   outside any Pallas kernel),
5. gather + combine with the routing weights.

Over a mesh the routing and the expert GEMMs run on DTensors; the top-k,
the positions, the scatter into and the gather out of the capacity
buffers run on each rank's shards (``common.kernel_call``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import Spec
from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig

Params = cm.Params


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    """The reference's shapes and scales: ``router`` (D, E) / √D, ``w_gate``
    (gated MLPs) and ``w_up`` (E, D, F) / √D, ``w_down`` (E, F, D) / √F."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": cm.dense_init(gen, (d, e), dtype, device)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = cm.dense_init(gen, (e, d, f), dtype, device, fan_in=d)
    p["w_up"] = cm.dense_init(gen, (e, d, f), dtype, device, fan_in=d)
    p["w_down"] = cm.dense_init(gen, (e, f, d), dtype, device, fan_in=f)
    return p


def capacity(cfg: ModelConfig, t: int, n: int) -> int:
    """Slots per expert for ``n`` tokens of sequence length ``t``: a single
    token per sequence (decode) is dropless, ``n·k``; otherwise
    ``max(8, ceil(cf·n·k/E/8)·8)``, at most ``n``."""
    k, e = cfg.top_k, cfg.n_experts
    if t == 1:
        return n * k
    cap = max(8, int(math.ceil(cfg.capacity_factor * n * k / e / 8.0)) * 8)
    return min(cap, n)


class Routing(NamedTuple):
    """One dispatch over ``ds`` shards of ``nl`` tokens: the ``tokens``
    (ds, nl, D); per (token, choice) slot in token-major order its expert
    ``assign`` (ds, nl·k), position ``pos`` in that expert's buffer of its
    shard and ``keep`` (pos < cap); the combine ``weights`` (ds, nl, k) in
    x's dtype; the capacity ``cap`` of a shard; the load-balancing ``aux``
    loss (fp32 scalar)."""
    tokens: torch.Tensor
    assign: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    weights: torch.Tensor
    cap: int
    aux: torch.Tensor


def _dp_size(env: cm.ShardEnv) -> int:
    if env.mesh is None:
        return 1
    return env._axis_size(env.batch_axes)


def _positions(assign: torch.Tensor, e: int) -> torch.Tensor:
    """Per shard, each slot's count of the earlier slots of its expert:
    (s, n·k) -> (s, n·k).  Expert-major, so the exclusive cumsum runs along
    the inner dim (a scan along the outer dim of (n·k, E) has E threads'
    worth of parallelism)."""
    onehot = F.one_hot(assign, e).transpose(1, 2).contiguous()   # (s, E, n·k)
    return (onehot.cumsum(dim=2) - onehot).gather(1, assign[:, None])[:, 0]


def routing(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
            env: cm.ShardEnv = cm.NO_SHARD) -> Routing:
    """The routing of ``x`` (B, T, D) by the ``router`` weights (D, E), in
    ``_dp_size(env)`` shards (one shard when that does not divide B·T).
    The logits are the fp32 product of fp32 operands (the reference's
    ``preferred_element_type=float32``; a bf16 product rounded to 8 bits
    would make top-k ties common)."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * t
    ds = _dp_size(env)
    if n % ds:
        ds = 1
    nl = n // ds
    shards = Spec(env.batch_axes, None, None)
    xs = env.constrain(env.gather_seq(x).reshape(ds, nl, d), shards)
    logits = env.constrain(xs.float() @ router.float(), shards)  # (ds, nl, E)
    probs = torch.softmax(logits, dim=-1)
    # on each rank's shard: topk's backward is not DTensor's on every release
    top_vals, top_idx = cm.kernel_call(
        lambda lg: torch.topk(lg, k, dim=-1, sorted=True), (0, 0), logits)
    weights = torch.softmax(top_vals, dim=-1).to(x.dtype)
    # load-balancing aux (Switch): E * sum_e frac_e * mean prob_e
    frac = F.one_hot(top_idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * (frac * probs.mean(dim=(0, 1))).sum()
    assign = top_idx.reshape(ds, nl * k)
    pos = cm.kernel_call(lambda a: _positions(a, e), 0, assign)
    cap = capacity(cfg, t, nl)
    return Routing(xs, assign, pos, pos < cap, weights, cap, aux)


def experts(params: Params, buf: torch.Tensor, mlp_type: str,
            env: cm.ShardEnv = cm.NO_SHARD) -> torch.Tensor:
    """The expert MLPs over the capacity buffers (ds, E, C, D) -> (ds, E, C,
    D): products in the weights' dtype, the activation in fp32, then a cast
    back (``common.mlp_apply``'s convention); ``gelu`` is the tanh form."""
    def mm(a, w):
        return torch.einsum("seck,ekn->secn", a, w)
    up = mm(buf, env.weight(params["w_up"], 2))
    if mlp_type in ("swiglu", "geglu"):
        act = F.silu if mlp_type == "swiglu" else cm.gelu
        h = act(mm(buf, env.weight(params["w_gate"], 2)).float()) * up.float()
    else:
        h = cm.gelu(up.float())
    h = env.constrain(h.to(buf.dtype), Spec(env.dp, None, None, env.tp))
    return mm(h, env.weight(params["w_down"], 1))


def _scatter(x_rep: torch.Tensor, assign: torch.Tensor, pos: torch.Tensor,
             keep: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """Per shard, the kept slots of x_rep (s, n·k, D) written into capacity
    buffers (s, E, C, D), once each (every kept (expert, pos) is unique);
    the dropped ones go to a spare row per shard.  This gives the
    reference's buffers (it adds zeros at a clamped slot) without atomics."""
    s, nk, d = x_rep.shape
    rows = torch.where(keep, assign * cap + pos, e * cap)
    rows = rows + torch.arange(s, device=rows.device)[:, None] * (e * cap + 1)
    buf = x_rep.new_zeros((s * (e * cap + 1), d)).index_put(
        (rows.reshape(-1),), x_rep.reshape(s * nk, d))
    return buf.view(s, e * cap + 1, d)[:, :e * cap].reshape(s, e, cap, d)


def _gather(out: torch.Tensor, assign: torch.Tensor, pos: torch.Tensor,
            keep: torch.Tensor) -> torch.Tensor:
    """Per shard, each slot's row of the expert outputs (s, E, C, D), zero
    for a dropped slot: (s, n·k, D)."""
    s, e, cap, d = out.shape
    idx = assign * cap + torch.clamp(pos, max=cap - 1)
    idx = idx + torch.arange(s, device=idx.device)[:, None] * (e * cap)
    y = out.reshape(s * e * cap, d)[idx.reshape(-1)].reshape(*idx.shape, d)
    return y * keep[..., None].to(y.dtype)


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
              env: cm.ShardEnv = cm.NO_SHARD
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, D) -> (y (B, T, D), aux loss fp32 scalar)."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = routing(params["router"], x, cfg, env)
    ds, nl, _ = r.tokens.shape
    buffers = Spec(env.batch_axes, None, None, None)
    x_rep = r.tokens.repeat_interleave(k, dim=1)               # (ds, nl·k, D)
    buf = env.constrain(cm.kernel_call(lambda *a: _scatter(*a, e, r.cap), 0,
                                       x_rep, r.assign, r.pos, r.keep), buffers)
    out = env.constrain(experts(params, buf, cfg.mlp_type, env), buffers)
    y_rep = cm.kernel_call(_gather, 0, out, r.assign, r.pos, r.keep)  # (ds, nl·k, D)
    y = (y_rep.reshape(ds, nl, k, d) * r.weights[..., None]).sum(dim=2)
    if b % ds:
        # fewer sequences than shards (the batch itself replicates): DTensor
        # cannot view shards that split sequences as (B, T)
        y = env.replicate(y)
    return cm.anchor(y.reshape(b, t, d)), r.aux
