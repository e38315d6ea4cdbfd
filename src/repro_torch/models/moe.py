"""Mixture-of-Experts layer (mixtral / grok-1), the port of
``repro.models.moe``: top-k routing with capacity buffers and batched
expert GEMMs.

Dispatch, with static buffer shapes as the reference's:

1. router logits in fp32 -> ``torch.topk`` (k experts per token, descending,
   the combine weights a softmax over the k),
2. each slot's position in its expert: an exclusive cumsum of the one-hot
   over the token-major (token, choice) slots, so the later tokens' slots
   are the ones past capacity (``routing``),
3. the kept slots written into per-expert capacity buffers (E, C, D);
   slots past capacity are DROPPED (GShard-style; ``capacity_factor`` sets
   the drop rate),
4. the expert GEMMs ``(E, C, D) x (E, D, F)`` as ``torch.bmm`` (the
   reference's einsums, outside any Pallas kernel),
5. gather + combine with the routing weights.

The reference's data-parallel dispatch shards (``_dp_size`` over a mesh)
have no counterpart on one card: the dispatch is one shard of all tokens.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

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
    """One dispatch: per (token, choice) slot in token-major order its
    expert ``assign`` (n·k,), position ``pos`` in that expert's buffer and
    ``keep`` (pos < cap); the combine ``weights`` (n, k) in x's dtype; the
    capacity ``cap``; the load-balancing ``aux`` loss (fp32 scalar)."""
    assign: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    weights: torch.Tensor
    cap: int
    aux: torch.Tensor


def routing(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The routing of ``x`` (B, T, D) by the ``router`` weights (D, E).  The
    logits are the fp32 product of fp32 operands (the reference's
    ``preferred_element_type=float32``; a bf16 product rounded to 8 bits
    would make top-k ties common)."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * t
    logits = x.reshape(n, d).float() @ router.float()          # (n, E)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(logits, k, dim=-1, sorted=True)
    weights = torch.softmax(top_vals, dim=-1).to(x.dtype)
    # load-balancing aux (Switch): E * sum_e frac_e * mean prob_e
    frac = F.one_hot(top_idx[:, 0], e).float().mean(dim=0)
    aux = e * (frac * probs.mean(dim=0)).sum()
    assign = top_idx.reshape(n * k)
    # expert-major, so the exclusive cumsum runs along the inner dim (a scan
    # along the outer dim of (n·k, E) has E threads' worth of parallelism)
    onehot = F.one_hot(assign, e).T.contiguous()               # (E, n·k)
    pos = (onehot.cumsum(dim=1) - onehot).gather(0, assign[None])[0]
    cap = capacity(cfg, t, n)
    return Routing(assign, pos, pos < cap, weights, cap, aux)


def experts(params: Params, buf: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """The expert MLPs over the capacity buffers (E, C, D) -> (E, C, D):
    products in the weights' dtype, the activation in fp32, then a cast
    back (``common.mlp_apply``'s convention); ``gelu`` is the tanh form."""
    if mlp_type in ("swiglu", "geglu"):
        act = F.silu if mlp_type == "swiglu" else cm.gelu
        h = (act(torch.bmm(buf, params["w_gate"]).float())
             * torch.bmm(buf, params["w_up"]).float())
    else:
        h = cm.gelu(torch.bmm(buf, params["w_up"]).float())
    return torch.bmm(h.to(buf.dtype), params["w_down"])


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, D) -> (y (B, T, D), aux loss fp32 scalar).

    The kept slots are written once each (every kept (expert, pos) is
    unique), the dropped ones into one spare row past the buffers, which
    gives the reference's buffers (it adds zeros at a clamped slot) without
    atomics."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = routing(params["router"], x, cfg)
    slot = r.assign * r.cap + r.pos                            # (n·k,)
    rows = torch.where(r.keep, slot, e * r.cap)
    x_rep = x.reshape(b * t, d).repeat_interleave(k, dim=0)    # (n·k, D)
    buf = x.new_zeros((e * r.cap + 1, d)).index_put((rows,), x_rep)
    out = experts(params, buf[:e * r.cap].view(e, r.cap, d), cfg.mlp_type)
    gathered = r.assign * r.cap + torch.clamp(r.pos, max=r.cap - 1)
    y_rep = out.reshape(e * r.cap, d)[gathered] * r.keep[:, None].to(x.dtype)
    y = (y_rep.reshape(b * t, k, d) * r.weights[..., None]).sum(dim=1)
    return y.reshape(b, t, d), r.aux
