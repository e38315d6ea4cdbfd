"""``meta``-tensor stand-ins for every (arch x shape-cell) input, the port of
``repro.launch.specs``.

``input_specs`` returns abstract inputs for the dry run: the shapes and
dtypes of the real ones on the ``meta`` device, which holds no data, so a
full-size cell costs no memory.  Train and prefill cells produce a Batch;
decode cells produce (tokens, cache), the cache from the model's own
constructor on ``meta``.

Cell skip policy (as the reference's): ``long_500k`` only for
sub-quadratic archs (ssm/hybrid/sliding-window); nothing else is skipped.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.data.pipeline import Batch
from repro_torch.models.config import ModelConfig, ShapeCell, get_shape_cell
from repro_torch.models.model import Model, build_model

META = torch.device("meta")

# archs with bounded-window or recurrent context -> long_500k runnable
_SUBQUADRATIC = {"ssm", "hybrid"}


def cell_supported(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    if cell.name == "long_500k":
        if cfg.family in _SUBQUADRATIC:
            return True, ""
        if cfg.attn_window > 0:
            return True, ""  # SWA / local-global: rolling caches bound memory
        return False, ("pure full-attention arch: 500k decode KV grows "
                       "unboundedly; skipped per DESIGN.md")
    return True, ""


def batch_spec(cfg: ModelConfig, cell: ShapeCell) -> Batch:
    """Abstract Batch for train/prefill cells (mirrors data.pipeline logic)."""
    b, s = cell.global_batch, cell.seq_len
    patches = None
    if cfg.frontend == "vision":
        s = max(8, s - cfg.frontend_tokens)
        patches = torch.empty((b, cfg.frontend_tokens, cfg.frontend_dim),
                              dtype=torch.float32, device=META)
    elif cfg.frontend == "audio":
        enc_len = cell.seq_len
        s = min(s, 4096)
        patches = torch.empty((b, enc_len, cfg.frontend_dim),
                              dtype=torch.float32, device=META)
    tokens = torch.empty((b, s), dtype=torch.int32, device=META)
    return Batch(tokens=tokens,
                 labels=torch.empty((b, s), dtype=torch.int32, device=META),
                 patches=patches)


def decode_specs(model: Model, cell: ShapeCell) -> Dict[str, Any]:
    """Abstract (tokens, cache) for decode cells: one new token against a
    cache of ``cell.seq_len`` context."""
    cfg = model.cfg
    b = cell.global_batch
    kw = {}
    if cfg.family == "encdec":
        kw["enc_len"] = min(cell.seq_len, 32768)
    cache = model.init_cache(b, cell.seq_len, device=META, **kw)
    tokens = torch.empty((b, 1), dtype=torch.int32, device=META)
    return {"tokens": tokens, "cache": cache}


def input_specs(cfg: ModelConfig, cell_name: str) -> Dict[str, Any]:
    cell = get_shape_cell(cell_name)
    ok, why = cell_supported(cfg, cell)
    if not ok:
        raise ValueError(f"{cfg.name} x {cell_name} skipped: {why}")
    model = build_model(cfg)
    if cell.kind in ("train", "prefill"):
        return {"batch": batch_spec(cfg, cell), "kind": cell.kind}
    return {**decode_specs(model, cell), "kind": "decode"}
