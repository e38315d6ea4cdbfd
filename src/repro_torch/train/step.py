"""Training step builder, the port of ``repro.train.step``: loss -> grad ->
clip -> optimizer, with optional gradient accumulation (micro-batches).

The step is ``(state, batch) -> (state, {"loss", "grad_norm", "lr"})``.  The
gradients are ``torch.autograd.grad`` of ``model.loss`` over the parameter
leaves; the optimizer writes the new state into the old one's tensors (the
reference's jitted step donates its state), so the state passed in is
consumed.  ``TrainState`` is a ``NamedTuple``: ``checkpoint.save`` writes its
leaves under the reference's paths (``.params/...``, ``.opt_state/...``).

Over a mesh (``env`` with a mesh, the state placed by
``distributed.sharding.param_shardings``/``opt_state_shardings``, the batch
by ``batch_specs``) the leaves are DTensors: each gradient comes back with
its parameter's placements, and a micro-batch is the same slice of every
rank's shard of the batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import placement as _pl
from repro_torch.data.pipeline import Batch
from repro_torch.models.common import NO_SHARD, ShardEnv
from repro_torch.models.model import Model


class TrainState(NamedTuple):
    params: Any
    opt_state: Any

    @property
    def step(self) -> torch.Tensor:
        return self.opt_state["count"]


def init_state(model: Model, optimizer, generator: torch.Generator,
               device="cuda") -> TrainState:
    params = model.init(generator, device)
    return TrainState(params=params, opt_state=optimizer.init(params))


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient with its parameter's placements (partial sums reduced)."""
    if _pl.is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def loss_and_grads(model: Model, params, batch: Batch,
                   env: ShardEnv = NO_SHARD):
    """(loss, grads): the loss of ``batch`` (detached; a plain tensor, the
    same on every rank over a mesh) and its gradient over every parameter
    leaf, in the tree of ``params``, each with its parameter's placements;
    ``params`` is left as it is."""
    leaves, spec = pytree.tree_flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = model.loss(pytree.tree_unflatten(req, spec), batch.tokens,
                          batch.labels, batch.patches, env=env)
        grads = torch.autograd.grad(loss, req)
    grads = [_placed_like(g, p) for g, p in zip(grads, leaves)]
    return _pl.local(loss.detach()), pytree.tree_unflatten(grads, spec)


def _micro(t: Optional[torch.Tensor], i: int, n: int) -> Optional[torch.Tensor]:
    """Micro-batch ``i`` of ``n`` of a batch leaf: rows ``[i·m, (i+1)·m)``,
    of each rank's shard for a DTensor (which keeps its placements)."""
    if t is None:
        return None
    loc = _pl.local(t)
    if loc.shape[0] % n:
        raise ValueError(f"a batch shard of {loc.shape[0]} rows does not split "
                         f"into {n} micro-batches")
    m = loc.shape[0] // n
    part = loc[i * m:(i + 1) * m]
    if not _pl.is_dtensor(t):
        return part
    return _pl.wrap(part, t.device_mesh, t.placements,
                    (t.shape[0] // n,) + tuple(t.shape[1:]))


def make_train_step(model: Model, optimizer, env: ShardEnv = NO_SHARD,
                    accum_steps: int = 1, accum_dtype: str = "float32"
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    adt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[accum_dtype]

    def train_step(state: TrainState, batch: Batch):
        if accum_steps == 1:
            loss, grads = loss_and_grads(model, state.params, batch, env)
        else:
            b = batch.tokens.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} does not split into "
                                 f"{accum_steps} micro-batches")
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch.tokens.device)
            grads = pytree.tree_map(
                lambda p: torch.zeros_like(p, dtype=adt), state.params)
            for i in range(accum_steps):
                part = Batch(*(_micro(t, i, accum_steps)
                               for t in (batch.tokens, batch.labels,
                                         batch.patches)))
                l, g = loss_and_grads(model, state.params, part, env)
                loss = loss + l
                grads = pytree.tree_map(lambda a, gg: a + gg.to(a.dtype),
                                        grads, g)
            inv = 1.0 / accum_steps
            loss = loss * inv
            grads = pytree.tree_map(lambda g: g * inv, grads)
        params, opt_state, metrics = optimizer.update(
            grads, state.opt_state, state.params)
        return (TrainState(params=params, opt_state=opt_state),
                {"loss": loss, **metrics})

    return train_step
