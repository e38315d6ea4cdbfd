"""Deterministic synthetic data pipeline (ds-array-backed), the port of
``repro.data.pipeline``.

Batch ``i`` is a pure function of ``(seed, i)``: a fresh ``torch.Generator``
on the pipeline's device, seeded from ``(seed, i)`` through NumPy's
``SeedSequence``, draws it, so restart-at-step-k needs no replay and the
cursor is one integer in the checkpoint.  The law is the reference's: a
random walk of steps in [-3, 3] from a uniform start, modulo the vocabulary,
with labels rolled by one.  torch cannot replay ``jax.random``, so the
tokens follow the law, not the reference's bits.  ``as_dsarray`` exposes a
batch as a ds-array on its device, so the algorithm layer composes.

With a ``mesh`` every rank draws the same whole batch and keeps its shard:
each leaf is a DTensor whose leading dim is split over ``dp_axes``
(``distributed.sharding.batch_specs``), the tokens those of the batch
without a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import placement as _pl
from repro_torch.core.dsarray import DsArray, from_array, resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    vocab_size: int = 256
    frontend: str = "none"          # none | vision | audio
    frontend_dim: int = 0
    frontend_tokens: int = 0


@dataclasses.dataclass
class Batch:
    tokens: torch.Tensor                    # (B, S) int32
    labels: torch.Tensor                    # (B, S) int32  (next-token)
    patches: Optional[torch.Tensor] = None  # (B, P, F) frontend embeddings

    def as_dsarray(self, block_rows: Optional[int] = None) -> DsArray:
        br = block_rows or max(1, self.tokens.shape[0] // 8)
        return from_array(self.tokens, (br, self.tokens.shape[1]),
                          device=self.tokens.device)


def _step_seed(seed: int, step: int) -> int:
    """The 64-bit seed of batch ``step``'s generator."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def _gen_batch(gen: torch.Generator, cfg: PipelineConfig,
               device: torch.device) -> Batch:
    """Markov-ish synthetic tokens: a random walk so the next-token task is
    learnable (the loss visibly decreases)."""
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    i32 = dict(dtype=torch.int32, device=device, generator=gen)
    base = torch.randint(0, v, (b, 1), **i32)
    steps = torch.randint(-3, 4, (b, s), **i32)
    tokens = torch.remainder(base + torch.cumsum(steps, dim=1, dtype=torch.int32), v)
    labels = torch.roll(tokens, -1, dims=1)
    patches = None
    if cfg.frontend != "none":
        patches = torch.randn((b, cfg.frontend_tokens, cfg.frontend_dim),
                              generator=gen, device=device)
    return Batch(tokens=tokens, labels=labels, patches=patches)


class SyntheticPipeline:
    """Stateless-per-step pipeline; ``state`` is just the step cursor."""

    def __init__(self, cfg: PipelineConfig, mesh=None,
                 dp_axes: Tuple[str, ...] = ("data",), device=None):
        """``device`` defaults to the mesh's device type, else ``"cuda"``."""
        self.cfg = cfg
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes)
        if device is None:
            device = mesh.device_type if mesh is not None else "cuda"
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Batch:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_step_seed(self.cfg.seed, step))
        batch = _gen_batch(gen, self.cfg, self.device)
        if self.mesh is None:
            return batch
        from repro_torch.distributed.sharding import batch_specs
        specs = batch_specs(batch, self.mesh, self.dp_axes)
        return Batch(*(None if t is None else _pl.place(
            t, self.mesh, _pl.spec_placements(self.mesh, getattr(specs, f)))
            for f, t in (("tokens", batch.tokens), ("labels", batch.labels),
                         ("patches", batch.patches))))

    def iterate(self, start_step: int = 0) -> Iterator[Tuple[int, Batch]]:
        step = start_step
        while True:
            yield step, self.batch_at(step)
            step += 1


def pipeline_for_model(mcfg: ModelConfig, global_batch: int, seq_len: int,
                       mesh=None, dp_axes: Tuple[str, ...] = ("data",),
                       seed: int = 0, device=None) -> SyntheticPipeline:
    ft = mcfg.frontend
    f_tokens = mcfg.frontend_tokens
    if ft == "audio":
        f_tokens = seq_len  # encoder frames track the shape cell's seq_len
        seq_len = min(seq_len, 4096)  # decoder text length
    if ft == "vision":
        seq_len = max(8, seq_len - f_tokens)  # patch prefix + text = cell seq
    pcfg = PipelineConfig(seed=seed, global_batch=global_batch,
                          seq_len=seq_len, vocab_size=mcfg.vocab_size,
                          frontend=ft, frontend_dim=mcfg.frontend_dim,
                          frontend_tokens=f_tokens)
    return SyntheticPipeline(pcfg, mesh, dp_axes, device)
