"""Model flops, from a configuration's sizes alone (PaLM's convention,
arXiv:2204.02311 App. B): a training step is 6·N·tokens and a forward
2·N·tokens, N the parameters applied to each token outside the input
embedding (the output head included), plus the attention's own products:
4·d_head·heads per (query, key) pair that the causal or windowed mask
keeps, per application of an attention layer, three times that in
training.  Recomputation is never counted, nor the SSD's own mixing, nor a
norm's or an activation's elementwise work.

``m`` is a configuration's ``model`` dict (the port's ``ModelConfig``
fields).
"""

from __future__ import annotations


def _hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def attn_params(m: dict) -> int:
    d, h, hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], _hd(m)
    return d * h * hd + 2 * d * hkv * hd + h * hd * d


def mlp_params(m: dict) -> int:
    gated = m.get("mlp_type", "swiglu") in ("swiglu", "geglu")
    return (3 if gated else 2) * m["d_model"] * m["d_ff"]


def mamba_params(m: dict) -> int:
    d = m["d_model"]
    dinner = m.get("ssm_expand", 2) * d
    s, g = m["ssm_state"], m.get("ssm_ngroups", 1)
    h = dinner // m.get("ssm_headdim", 64)
    return d * (2 * dinner + 2 * g * s + h) + dinner * d


def applied_params(m: dict) -> int:
    """Parameters applied to each token by a product (the matrices), the
    output head included, the input embedding not: the hybrid's shared block
    once per application, a sparse-expert layer's router and ``top_k``
    experts."""
    head = m["d_model"] * m["vocab_size"]
    if m["family"] == "hybrid":
        apps = m["n_layers"] // m["share_period"]
        return (m["n_layers"] * mamba_params(m)
                + apps * (attn_params(m) + mlp_params(m)) + head)
    if m["family"] == "moe":
        layer = (attn_params(m) + m["d_model"] * m["n_experts"]
                 + m["top_k"] * mlp_params(m))
        return m["n_layers"] * layer + head
    raise ValueError(f"no count for the family {m['family']!r}")


def attention_layers(m: dict) -> int:
    """Applications of an attention layer in one forward."""
    if m["family"] == "hybrid":
        return m["n_layers"] // m["share_period"]
    return m["n_layers"]


def pairs(t: int, window: int = 0) -> int:
    """(query, key) pairs a causal mask over ``t`` positions keeps, within
    ``window`` positions when it is not 0."""
    if window <= 0 or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def attention_flops(m: dict, batch: int, seq: int) -> int:
    """The forward's attention products: 4·d_head·heads a kept pair."""
    return (4 * _hd(m) * m["n_heads"] * batch * pairs(seq, m.get("attn_window", 0))
            * attention_layers(m))


def forward(m: dict, batch: int, seq: int) -> int:
    return 2 * applied_params(m) * batch * seq + attention_flops(m, batch, seq)


def train_step(m: dict, batch: int, seq: int) -> int:
    return 3 * forward(m, batch, seq)


def kmeans_pass(n: int, k: int, d: int) -> int:
    """One assignment pass: 2·n·k·d (the distances' products)."""
    return 2 * n * k * d
