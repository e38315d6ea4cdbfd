"""Model registry, the port of ``repro.models.model``: one functional
interface per architecture family.

    model = build_model(cfg)
    params = model.init(generator, device="cuda")
    logits, aux = model.forward(params, tokens)
    cache = model.init_cache(batch, max_len, device="cuda")
    logits, cache = model.decode_step(params, cache, tokens)

Only the ``hybrid`` family (zamba2) is ported; the others raise ``KeyError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.dsarray import resolve_device
from repro_torch.models import hybrid
from repro_torch.models.config import ModelConfig

_FAMILY_MODULES = {"hybrid": hybrid}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    module: Any

    def init(self, generator: torch.Generator, device="cuda"):
        return self.module.init_params(generator, self.cfg, resolve_device(device))

    def forward(self, params, tokens):
        return self.module.forward(params, self.cfg, tokens)

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return self.module.init_cache(self.cfg, batch, max_len,
                                      resolve_device(device))

    def decode_step(self, params, cache, tokens):
        return self.module.decode_step(params, self.cfg, cache, tokens)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILY_MODULES:
        raise KeyError(f"family {cfg.family!r} is not ported to repro_torch yet "
                       f"(ported: {', '.join(_FAMILY_MODULES)}; see ROADMAP.md)")
    return Model(cfg=cfg, module=_FAMILY_MODULES[cfg.family])
