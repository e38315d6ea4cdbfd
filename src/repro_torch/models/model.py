"""Model registry, the port of ``repro.models.model``: one functional
interface per architecture family.

    model = build_model(cfg)
    params = model.init(generator, device="cuda")
    logits, aux = model.forward(params, tokens, patches)
    loss = model.loss(params, tokens, labels, patches)
    cache = model.init_cache(batch, max_len, device="cuda")
    logits, cache = model.decode_step(params, cache, tokens)

``forward``, ``loss`` and ``decode_step`` take ``env`` (a
``common.ShardEnv``; ``NO_SHARD`` by default): with a mesh, the parameters
and inputs are DTensors placed by ``distributed.sharding``.

Every family of the reference: ``dense``, ``moe`` and ``vlm``
(``transformer``; its MoE layers in ``moe``), ``ssm``, ``hybrid`` and
``encdec`` (whose ``patches`` are the encoder frames, and whose
``init_cache`` takes ``enc_len=``, the encoder slots, as the reference's
``**kw`` does).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.dsarray import resolve_device
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.common import NO_SHARD, ShardEnv
from repro_torch.models.config import ModelConfig

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": ssm,
    "hybrid": hybrid,
    "encdec": encdec,
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    module: Any

    def init(self, generator: torch.Generator, device="cuda"):
        return self.module.init_params(generator, self.cfg, resolve_device(device))

    def forward(self, params, tokens, patches=None, env: ShardEnv = NO_SHARD):
        return self.module.forward(params, self.cfg, tokens, patches, env=env)

    def loss(self, params, tokens, labels, patches=None,
             env: ShardEnv = NO_SHARD):
        return self.module.loss_fn(params, self.cfg, tokens, labels, patches,
                                   env=env)

    def init_cache(self, batch: int, max_len: int, device="cuda", **kw):
        return self.module.init_cache(self.cfg, batch, max_len,
                                      resolve_device(device), **kw)

    def decode_step(self, params, cache, tokens, env: ShardEnv = NO_SHARD):
        return self.module.decode_step(params, self.cfg, cache, tokens, env=env)

    @property
    def needs_patches(self) -> bool:
        return self.cfg.frontend != "none"


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILY_MODULES:
        raise KeyError(f"unknown family {cfg.family!r} (known: "
                       f"{', '.join(_FAMILY_MODULES)})")
    return Model(cfg=cfg, module=_FAMILY_MODULES[cfg.family])
