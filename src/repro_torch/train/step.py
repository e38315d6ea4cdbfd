"""Training step builder, the port of ``repro.train.step``: loss -> grad ->
clip -> optimizer, with optional gradient accumulation (micro-batches).

The step is ``(state, batch) -> (state, {"loss", "grad_norm", "lr"})``.  The
gradients are ``torch.autograd.grad`` of ``model.loss`` over the parameter
leaves; the optimizer writes the new state into the old one's tensors (the
reference's jitted step donates its state), so the state passed in is
consumed.  ``TrainState`` is a ``NamedTuple``: ``checkpoint.save`` writes its
leaves under the reference's paths (``.params/...``, ``.opt_state/...``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.data.pipeline import Batch
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


def loss_and_grads(model: Model, params, batch: Batch):
    """(loss, grads): the loss of ``batch`` (detached) and its gradient over
    every parameter leaf, in the tree of ``params``; ``params`` is left as
    it is."""
    leaves, spec = pytree.tree_flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = model.loss(pytree.tree_unflatten(req, spec), batch.tokens,
                          batch.labels, batch.patches)
        grads = torch.autograd.grad(loss, req)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def make_train_step(model: Model, optimizer, accum_steps: int = 1,
                    accum_dtype: str = "float32"
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    adt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[accum_dtype]

    def train_step(state: TrainState, batch: Batch):
        if accum_steps == 1:
            loss, grads = loss_and_grads(model, state.params, batch)
        else:
            b = batch.tokens.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} does not split into "
                                 f"{accum_steps} micro-batches")
            mb = b // accum_steps
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch.tokens.device)
            grads = pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=adt, device=p.device),
                state.params)
            for i in range(accum_steps):
                part = Batch(*(None if t is None else t[i * mb:(i + 1) * mb]
                               for t in (batch.tokens, batch.labels,
                                         batch.patches)))
                l, g = loss_and_grads(model, state.params, part)
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
