"""Unified architecture config, the port of ``repro.models.config``: the same
fields and properties; ``dtype`` stays a string and ``activation_dtype``
returns the torch dtype."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default d_model // n_heads

    # -- attention features ---------------------------------------------------
    attn_window: int = 0             # sliding-window size (0 = full attention)
    local_global_period: int = 0     # gemma2: every p-th layer is global
    attn_softcap: float = 0.0        # gemma2/grok logit soft-capping
    final_softcap: float = 0.0       # gemma2 final-logit soft-capping
    qkv_bias: bool = False           # qwen1.5
    rope_theta: float = 10000.0

    # -- mlp --------------------------------------------------------------------
    mlp_type: str = "swiglu"         # swiglu | relu2 | gelu
    tie_embeddings: bool = False

    # -- MoE ---------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # -- SSM (mamba2) -----------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 128
    ssm_conv: int = 4

    # -- hybrid (zamba2) ---------------------------------------------------------
    share_period: int = 0            # shared attn block applied every k SSM layers

    # -- enc-dec (seamless) --------------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0

    # -- modality frontend stub ------------------------------------------------------
    frontend: str = "none"           # none | vision | audio
    frontend_dim: int = 0            # raw patch/frame embedding width
    frontend_tokens: int = 0         # patch/frame count prepended to the sequence

    # -- numerics / training ----------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True               # activation checkpointing per layer

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def ssm_dinner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_dinner // self.ssm_headdim

    @property
    def activation_dtype(self):
        return _DTYPES[self.dtype]

    def layer_is_global(self, layer_idx: int) -> bool:
        """gemma2-style local/global alternation (odd layers global, p=2)."""
        if self.local_global_period <= 0:
            return self.attn_window == 0
        return (layer_idx % self.local_global_period) == self.local_global_period - 1

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6·N·D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        dense_mlp = (3 if self.mlp_type in ("swiglu", "geglu") else 2) * d * f
        norms = 2 * d
        if self.family == "ssm":
            dinner, s, g = self.ssm_dinner, self.ssm_state, self.ssm_ngroups
            h = self.ssm_heads
            in_proj = d * (2 * dinner + 2 * g * s + h)
            conv = self.ssm_conv * (dinner + 2 * g * s)
            per_layer = in_proj + conv + h + h + dinner + dinner * d + d  # A, D, norm, out
            body = self.n_layers * per_layer
        elif self.family == "hybrid":
            dinner, s, g = self.ssm_dinner, self.ssm_state, self.ssm_ngroups
            h = self.ssm_heads
            in_proj = d * (2 * dinner + 2 * g * s + h)
            conv = self.ssm_conv * (dinner + 2 * g * s)
            ssm_layer = in_proj + conv + h + h + dinner + dinner * d + d
            body = self.n_layers * ssm_layer + (attn + dense_mlp + norms)  # one shared block
        elif self.family == "moe":
            moe_mlp = self.n_experts * dense_mlp + d * self.n_experts
            body = self.n_layers * (attn + moe_mlp + norms)
        elif self.family == "encdec":
            enc = self.enc_layers * (attn + dense_mlp + norms)
            dec = self.dec_layers * (2 * attn + dense_mlp + 3 * d)
            body = enc + dec
        else:
            body = self.n_layers * (attn + dense_mlp + norms)
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.frontend == "vision":
            emb += self.frontend_dim * d + d * d  # 2-layer mm projector
        if self.frontend == "audio":
            emb += self.frontend_dim * d
        return int(body + emb + d)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_mlp = (3 if self.mlp_type in ("swiglu", "geglu") else 2) * d * f
        inactive = self.n_layers * (self.n_experts - self.top_k) * dense_mlp
        return int(self.param_count() - inactive)
