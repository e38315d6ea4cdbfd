"""The routing decisions of the sparse-expert layers, recorded where they are
made, so that the float32 reference can follow them.

Which experts a token goes to is a discrete choice: a router logit that
bf16 and float32 order differently sends a token elsewhere, and the
capacity drops after it move with it.  Two sound implementations then
differ by whole tokens, as much as a sound one and one in fp8, and no loss
or gradient gap could tell them apart.  So the reference follows the
program's expert choices and recomputes everything else itself, the drops
too: which slots an expert keeps follows from the choices by the
token-major capacity rule, which the reference applies on its own.  Two
numbers hold the program's routing to the reference's router:
``route_margin`` (``reference.models.margin``), the widest margin by which
the reference's logit of a chosen expert lies below the reference's own
logit of the same rank (a choice the reference would have made within
rounding reads near 0, a wrong one reads whole logits), over the spread of
the layer's logits; and ``drop_gap``, the share of slots whose keeping
differs from the reference's capacity rule on the same choices (0 for a
sound program).

A recorder is a list per call of the model: one ``(assign, keep)`` pair a
layer, in the order the layers run.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import List, Optional

import torch


class Recorder:
    """The routing of each forward the program runs while it records: under
    remat a training step routes each layer twice (the forward and its
    recomputation); ``layers`` keeps the first ``n_layers`` of each step."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        self.calls: List[list] = []
        self.open: Optional[list] = None

    def begin(self) -> None:
        self.open = []
        self.calls.append(self.open)

    def add(self, assign: torch.Tensor, keep: torch.Tensor) -> None:
        if self.open is not None and len(self.open) < self.n_layers:
            self.open.append((assign.reshape(-1), keep.reshape(-1)))


@contextlib.contextmanager
def recording(rec: Recorder):
    """The port's ``models.moe.routing`` wrapped so that ``rec`` sees each
    decision (the tensors themselves: no copy, no launch)."""
    mod = importlib.import_module("repro_torch.models.moe")
    real = mod.routing

    def routing(*args, **kw):
        r = real(*args, **kw)
        rec.add(r.assign, r.keep)
        return r

    mod.routing = routing
    try:
        yield rec
    finally:
        mod.routing = real


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """The port's ``models.moe.routing`` with a planted fault, for the fault
    tests: ``"route"`` sends each slot to the next expert (a choice altered
    where it is made), ``"drops"`` keeps 8 slots fewer an expert than the
    capacity (a wrong capacity rule); any other fault leaves it as it is."""
    if fault not in ("route", "drops"):
        yield
        return
    mod = importlib.import_module("repro_torch.models.moe")
    real = mod.routing

    def routing(router, x, cfg, *args, **kw):
        r = real(router, x, cfg, *args, **kw)
        if fault == "route":
            return r._replace(assign=(r.assign + 1) % cfg.n_experts)
        return r._replace(keep=r.pos < r.cap - 8)

    mod.routing = routing
    try:
        yield
    finally:
        mod.routing = real


class Follow:
    """What the reference's sparse-expert layers follow in one forward: the
    program's ``(assign, keep)`` of each layer, or None (each layer routes
    by the reference's own router).  Indexed by layer, so that a layer run
    again in the backward follows the same choices.  It keeps the widest
    ``margin`` and ``drops`` (``drop_gap``) it meets, and the choices it
    made itself (``own``)."""

    def __init__(self, layers=None):
        self.layers = layers
        self.own = {}
        self.margin = 0.0
        self.drops = 0.0

    def route(self, layer: int):
        return None if self.layers is None else self.layers[layer]

    def made(self, layer: int, assign: torch.Tensor, keep: torch.Tensor) -> None:
        self.own[layer] = (assign.detach(), keep.detach())

    def choices(self) -> list:
        """The reference's own choices, layer by layer (for another side to
        follow)."""
        return [self.own[i] for i in sorted(self.own)]

