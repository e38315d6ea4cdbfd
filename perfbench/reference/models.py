"""Plain float32 language models, from the published descriptions as the
configuration files state them: the Zamba2-style hybrid (Mamba-2 layers and
one shared attention+MLP block after every ``share_period`` of them) and the
decoder-only transformer with sparse experts (Mixtral).

``params`` is {dotted leaf name: float32 tensor} as ``weights.draw`` lays
the leaves out (per-layer leaves stacked on a leading axis); ``m`` is the
configuration's ``model`` dict.  Each layer group is checkpointed under
grad mode, so that a full-size backward fits beside the optimizer state.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import (attention, causal_conv, held, lm_loss, mm,
                                        rms_norm, rope, ssd, swiglu)

Params = Dict[str, torch.Tensor]


def _layers(params: Params, prefix: str, n: int):
    """The per-layer views of every leaf under ``prefix``, each stack
    unbound once (its gradient is then stacked once)."""
    parts = {k[len(prefix):]: v.unbind(0) for k, v in params.items()
             if k.startswith(prefix)}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _sub(params: Params, prefix: str) -> Params:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def _maybe_ckpt(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Attention block (the hybrid's shared block; Mixtral's attention)
# ---------------------------------------------------------------------------


def attn(p: Params, x: torch.Tensor, m: dict, window: int) -> torch.Tensor:
    b, t, _ = x.shape
    h, hkv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // h
    theta = m.get("rope_theta", 10000.0)
    q = mm(x, p["wq"]).reshape(b, t, h, hd).transpose(1, 2)
    k = mm(x, p["wk"]).reshape(b, t, hkv, hd).transpose(1, 2)
    v = mm(x, p["wv"]).reshape(b, t, hkv, hd).transpose(1, 2)
    o = attention(rope(q, theta), rope(k, theta), v, window)
    return mm(o.transpose(1, 2).reshape(b, t, h * hd), p["wo"])


# ---------------------------------------------------------------------------
# The hybrid
# ---------------------------------------------------------------------------


def mamba(p: Params, x: torch.Tensor, m: dict) -> torch.Tensor:
    b, t, d = x.shape
    dinner = m.get("ssm_expand", 2) * d
    s, g = m["ssm_state"], m.get("ssm_ngroups", 1)
    hp = m.get("ssm_headdim", 64)
    h = dinner // hp
    eps = m.get("norm_eps", 1e-6)
    proj = mm(rms_norm(x, p["norm"], eps), p["in_proj"])
    z, xbc, dt = proj.split([dinner, dinner + 2 * g * s, h], dim=-1)
    xbc = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, bm, cm = xbc.split([dinner, g * s, g * s], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = xs.reshape(b, t, h, hp)
    y = ssd(xh, dt, a, bm.reshape(b, t, g, s), cm.reshape(b, t, g, s),
            m.get("ssm_chunk", 128))
    y = (y + p["d_skip"][:, None] * xh).reshape(b, t, dinner)
    y = rms_norm(y * F.silu(z), p["gate_norm"], eps)
    return x + mm(y, p["out_proj"])


def shared_block(p: Params, x: torch.Tensor, m: dict, window: int) -> torch.Tensor:
    eps = m.get("norm_eps", 1e-6)
    x = x + attn(_sub(p, "attn."), rms_norm(x, p["ln1"], eps, True), m, window)
    h = rms_norm(x, p["ln2"], eps, True)
    return x + swiglu(h, p["mlp.w_gate"], p["mlp.w_up"], p["mlp.w_down"])


def hybrid_hidden(params: Params, m: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) -> the final hidden states (B, T, D)."""
    x = held(params["embed"][tokens.long()])
    per = m["share_period"]
    layers = _layers(params, "layers.", m["n_layers"])
    shared = _sub(params, "shared.")
    window = m.get("attn_window", 0)

    def group(x, *flat):
        lps = [dict(zip(keys, flat[i * len(keys):(i + 1) * len(keys)]))
               for i in range(per)]
        for lp in lps:
            x = held(mamba(lp, x, m))
        return held(shared_block(dict(zip(skeys, flat[per * len(keys):])), x, m, window))

    keys = sorted(layers[0])
    skeys = sorted(shared)
    for gi in range(m["n_layers"] // per):
        flat = [lp[k] for lp in layers[gi * per:(gi + 1) * per] for k in keys]
        x = _maybe_ckpt(group, x, *flat, *[shared[k] for k in skeys])
    return rms_norm(x, params["final_norm"], m.get("norm_eps", 1e-6))


# ---------------------------------------------------------------------------
# The transformer with sparse experts
# ---------------------------------------------------------------------------


def capacity(m: dict, t: int, n: int) -> int:
    """Slots per expert for n tokens of sequence length t (GShard-style):
    max(8, ceil(cf·n·k/E/8)·8), at most n; n·k for one token per sequence."""
    k, e = m["top_k"], m["n_experts"]
    if t == 1:
        return n * k
    cap = max(8, int(math.ceil(m["capacity_factor"] * n * k / e / 8.0)) * 8)
    return min(cap, n)


def margin(logits: torch.Tensor, assign: torch.Tensor) -> float:
    """The widest margin by which the logit of a chosen expert lies below
    the best logit of the same rank, over the logits' standard deviation:
    ``logits`` (n, E) the reference's, ``assign`` (n·k,) the choices, k a
    token in rank order.  A choice that repeats an expert of the same
    token reads as the worst expert."""
    n, e = logits.shape
    chosen = assign.reshape(n, -1)
    k = chosen.shape[1]
    best = torch.topk(logits, k, dim=-1, sorted=True).values
    got = logits.gather(1, chosen)
    onehot = F.one_hot(chosen, e)
    repeat = (onehot.cumsum(1) * onehot).sum(-1) > 1
    got = torch.where(repeat, logits.min(dim=-1, keepdim=True).values, got)
    spread = logits.std().clamp(min=1e-30)
    return float((best - got).clamp(min=0).max() / spread)


def keeps(assign: torch.Tensor, m: dict, t: int, e: int) -> torch.Tensor:
    """Which slots the experts keep: the slots (token, choice) in
    token-major order, each expert keeping its first ``capacity`` slots."""
    k = m["top_k"]
    onehot = F.one_hot(assign, e)
    pos = (onehot.cumsum(0) - onehot).gather(1, assign[:, None])[:, 0]
    return pos < capacity(m, t, assign.numel() // k)


def moe(p: Params, x: torch.Tensor, m: dict, follow=None, layer: int = 0):
    """Top-k routing over the experts with a capacity per expert: the slots
    (token, choice) in token-major order; an expert keeps its first
    ``capacity`` slots and drops the rest (a dropped slot adds nothing).
    The combine weights are a softmax over the router logits of the chosen
    experts.  With ``follow`` (a ``routing.Follow``) the experts chosen are
    the program's where it gives them, and the drops are this reference's
    own on them; ``follow`` keeps how far the choices lie from this
    router's (:func:`margin`) and the share of slots whose keeping the
    program decided otherwise.  Returns (y, the Switch load-balancing
    loss)."""
    b, t, d = x.shape
    e, k = m["n_experts"], m["top_k"]
    n = b * t
    xs = x.reshape(n, d)
    logits = mm(xs, p["router"])
    probs = torch.softmax(logits, dim=-1)
    assign = torch.topk(logits.detach(), k, dim=-1, sorted=True).indices.reshape(-1)
    given = follow.route(layer) if follow is not None else None
    if given is not None:
        g_assign, g_keep = (v.to(assign.device).reshape(-1) for v in given)
        if g_assign.numel() != assign.numel():
            follow.drops, given = 1.0, None     # choices for other tokens
        else:
            assign = g_assign.long()
            follow.margin = max(follow.margin, margin(logits.detach(), assign))
    keep = keeps(assign, m, t, e)
    if given is not None:
        follow.drops = max(follow.drops, float((g_keep.bool() != keep).float().mean()))
    if follow is not None:
        follow.made(layer, assign, keep)
    chosen = assign.reshape(n, k)
    weights = torch.softmax(logits.gather(1, chosen), dim=-1)
    frac = F.one_hot(chosen[:, 0], e).float().mean(dim=0)
    aux = e * (frac * probs.mean(dim=0)).sum()
    slot = torch.arange(n * k, device=x.device)
    y = torch.zeros_like(xs)
    for j in range(e):
        kept = slot[(assign == j) & keep]
        tok, choice = kept // k, kept % k
        out = swiglu(xs[tok], p["w_gate"][j], p["w_up"][j], p["w_down"][j])
        y = y.index_add(0, tok, out * weights[tok, choice][:, None])
    return y.reshape(b, t, d), aux


def moe_block(p: Params, x: torch.Tensor, m: dict, follow=None, layer: int = 0):
    eps = m.get("norm_eps", 1e-6)
    x = x + attn(_sub(p, "attn."), rms_norm(x, p["ln1"], eps, True), m,
                 m.get("attn_window", 0))
    h, aux = moe(_sub(p, "moe."), rms_norm(x, p["ln2"], eps, True), m, follow, layer)
    return x + h, aux


def moe_hidden(params: Params, m: dict, tokens: torch.Tensor, follow=None):
    """tokens (B, T) -> (final hidden states (B, T, D), summed aux loss)."""
    x = held(params["embed"][tokens.long()])
    layers = _layers(params, "groups.0.", m["n_layers"])
    keys = sorted(layers[0])
    aux = x.new_zeros(())
    for li, lp in enumerate(layers):
        def layer(x, *flat, li=li):
            x, a = moe_block(dict(zip(keys, flat)), x, m, follow, li)
            return held(x), a
        x, a = _maybe_ckpt(layer, x, *[lp[k] for k in keys])
        aux = aux + a
    return rms_norm(x, params["final_norm"], m.get("norm_eps", 1e-6), True), aux


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def loss(params: Params, m: dict, tokens: torch.Tensor, labels: torch.Tensor,
         follow=None) -> torch.Tensor:
    """The model's training loss: the token-mean cross-entropy with z-loss
    1e-4, plus 0.01·aux for the sparse-expert family, whose layers route as
    ``follow`` says (a ``routing.Follow``; their own router without one)."""
    if m["family"] == "hybrid":
        hidden = hybrid_hidden(params, m, tokens)
        return lm_loss(hidden, params["lm_head"], labels)
    if m["family"] == "moe":
        hidden, aux = moe_hidden(params, m, tokens, follow)
        return lm_loss(hidden, params["lm_head"], labels) + 0.01 * aux
    raise ValueError(f"no reference for the family {m['family']!r}")


def hidden(params: Params, m: dict, tokens: torch.Tensor) -> torch.Tensor:
    if m["family"] == "hybrid":
        return hybrid_hidden(params, m, tokens)
    return moe_hidden(params, m, tokens)[0]
