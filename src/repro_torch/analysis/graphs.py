"""The graph plane: the aten ops one run dispatches, and the helpers the
rules and the tests read it with (the port's counterpart of
``repro/analysis/jaxprs.py``).

:func:`trace_ops` is the counterpart of ``jax.make_jaxpr(fn)(*args)``: it
runs ``fn`` once under a ``TorchDispatchMode`` and keeps, for every aten op
dispatched, one :class:`OpNode` — the op's name, its outputs' shapes and
dtypes, its tensor operands' shapes, and whether it allocated its output
(``alloc``), returned a view of an operand (``view``) or wrote into one
(``inplace``).  ``Plan.graph()`` records one run of a plan this way and
tags each op with the plan node whose lowering dispatched it.

A kernel wrapper's call is ONE node, ``kernel:<name>`` (``kernels._record``),
whatever the call dispatches inside: on the card a ctypes launch the
dispatcher never sees (and the wrapper's own allocations), on the CPU the
plain version's dozens of ops.  The node plays the part of a
``pallas_call`` eqn, and the graph of a run is the same on both devices.

The run is real: it executes on the operands' own device (a ``meta``
tensor is refused — the meta paths skip the ops the card runs), launches
what it launches, and the recorder changes no route.  There is no compiler
between the trace and the run, so this one plane stands in for both the
reference's jaxpr and its optimised HLO: a tensor an op allocates is a
tensor the card writes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Iterator, List, Optional, Set

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.dsarray import DsArray
from repro_torch.core.sparse import StackedCOO
from repro_torch.kernels import _record

#: ops whose output is a new tensor header over existing memory, though
#: their schema declares no alias (``reshape`` of a copy ends in one)
_VIEW_OPS = frozenset({"aten._unsafe_view.default"})


@dataclasses.dataclass(frozen=True)
class OpNode:
    """One dispatched op (or one kernel-wrapper call) of a recorded run."""

    op: str                  # "aten.add.Tensor", or "kernel:stacked_matmul"
    kind: str                # "alloc" | "view" | "inplace" | "kernel"
    shapes: tuple            # output shapes
    dtypes: tuple            # output dtypes ("float32", ...)
    in_shapes: tuple         # tensor operands' shapes
    owner: Optional[int]     # plan node (emission-order index) being lowered
    scope: str = ""          # a helper's tag ("cast"), see kernels._record
    step: int = 0            # step of a fused body (kernels._record.step)
    output: bool = False     # it made a tensor the run returned

    @property
    def writes(self) -> bool:
        """True when the op writes a fresh tensor (an allocation or a
        kernel's output), not a view or an in-place update."""
        return self.kind in ("alloc", "kernel")

    @property
    def name(self) -> str:
        """The op without its overload: ``where`` for ``aten.where.self``,
        the node's op for a kernel."""
        parts = self.op.split(".")
        return parts[1] if parts[0] == "aten" and len(parts) > 1 else self.op

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        shp = ", ".join(f"{d}{list(s)}" for s, d in zip(self.shapes,
                                                        self.dtypes))
        tag = f" <{self.scope}>" if self.scope else ""
        step = f" s{self.step}" if self.step else ""
        return f"{self.op} -> {shp} ({self.kind}, n{self.owner}{step}){tag}"


class Graph:
    """The nodes of one recorded run, in dispatch order."""

    def __init__(self, nodes: List[OpNode], n_outputs: int):
        self.nodes = tuple(nodes)
        self.n_outputs = n_outputs

    def __iter__(self) -> Iterator[OpNode]:
        return iter(self.nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    def __eq__(self, other) -> bool:
        return isinstance(other, Graph) and self.nodes == other.nodes \
            and self.n_outputs == other.n_outputs

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return "\n".join(str(n) for n in self.nodes)


def _tensors(val) -> Iterator[torch.Tensor]:
    """The tensors in an op's operands or results, a run's ds-arrays and
    stacked COOs included."""
    if isinstance(val, torch.Tensor):
        yield val
    elif isinstance(val, StackedCOO):
        yield val.data
        yield val.indices
    elif isinstance(val, (list, tuple)):
        for v in val:
            yield from _tensors(v)
    elif isinstance(val, dict):
        for v in val.values():
            yield from _tensors(v)
    elif isinstance(val, DsArray):
        yield from _tensors(val.blocks)


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _kind(func) -> str:
    if str(func) in _VIEW_OPS:
        return "view"
    alias = [r.alias_info for r in func._schema.returns
             if r.alias_info is not None]
    if not alias:
        return "alloc"
    return "inplace" if any(a.is_write for a in alias) else "view"


class _Recorder(TorchDispatchMode):
    """The dispatch mode behind :func:`trace_ops`."""

    def __init__(self):
        super().__init__()
        self.nodes: List[dict] = []
        self._hidden = 0
        self._scope = ""
        self._owner: Optional[int] = None
        self._step = 0
        self._steps = 0
        self._made: dict = {}      # id(tensor) -> (weakref, node index)

    def _add(self, op: str, kind: str, out, operands) -> None:
        outs = list(_tensors(out))
        ins = list(_tensors(operands))
        if all(t.device.type == "meta" for t in outs + ins):
            return               # metadata inference, not the run's work
        idx = len(self.nodes)
        self.nodes.append(dict(
            op=op, kind=kind, shapes=tuple(tuple(t.shape) for t in outs),
            dtypes=tuple(_dtype(t) for t in outs),
            in_shapes=tuple(tuple(t.shape) for t in ins),
            owner=self._owner, scope=self._scope, step=self._step))
        for t in outs:
            self._made[id(t)] = (weakref.ref(t), idx)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._hidden:
            self._add(str(func), _kind(func), out, (args, kwargs))
        return out

    def opaque(self, name: str, fn, args, kwargs):
        """A kernel wrapper's call: one node, its inner ops hidden."""
        self._hidden += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._hidden -= 1
        if not self._hidden:
            self._add(f"kernel:{name}", "kernel", out, (args, kwargs))
        return out

    def scoped(self, scope: str, fn, args, kwargs):
        outer, self._scope = self._scope, scope
        try:
            return fn(*args, **kwargs)
        finally:
            self._scope = outer

    def step(self, fn, args):
        self._steps += 1
        outer, self._step = self._step, self._steps
        try:
            return fn(*args)
        finally:
            self._step = outer

    @contextlib.contextmanager
    def owned(self, index: int):
        outer, self._owner = self._owner, index
        try:
            yield
        finally:
            self._owner = outer

    def graph(self, result) -> Graph:
        outs = list(_tensors(result))
        for t in outs:
            hit = self._made.get(id(t))
            if hit is not None and hit[0]() is t:
                self.nodes[hit[1]]["output"] = True
        return Graph([OpNode(**n) for n in self.nodes], len(outs))


def trace_ops(fn, *args, **kwargs) -> Graph:
    """Run ``fn(*args, **kwargs)`` once and return the :class:`Graph` of the
    ops it dispatched (the counterpart of ``jax.make_jaxpr(fn)(*args)``).
    The run is a real one on the operands' device; ``meta`` operands are
    refused, since the meta paths skip the ops a real run makes."""
    if any(t.device.type == "meta" for t in _tensors((args, kwargs))):
        raise ValueError("trace_ops records a real run: meta tensors skip "
                         "the ops the card runs; pass tensors on the CPU or "
                         "the card")
    rec = _Recorder()
    token = _record.ACTIVE.set(rec)
    try:
        with rec:
            result = fn(*args, **kwargs)
    finally:
        _record.ACTIVE.reset(token)
    return rec.graph(result)


def owner(index: int):
    """Tag the ops dispatched inside the block with plan node ``index``
    (``Plan.graph()`` enters it around each node's lowering); a no-op with
    no recorder active."""
    rec = _record.ACTIVE.get()
    return rec.owned(index) if rec is not None else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Helpers (the counterparts of repro.analysis.jaxprs')
# ---------------------------------------------------------------------------


def walk(graph: Graph) -> Iterator[OpNode]:
    """Every node of the graph, in dispatch order (the counterpart of
    ``walk_eqns``; a graph has no sub-graphs: kernels are leaves)."""
    yield from graph.nodes


def primitives(graph: Graph) -> Set[str]:
    """The set of op names in the graph (``aten.add.Tensor``,
    ``kernel:stacked_matmul``, ...)."""
    return {n.op for n in walk(graph)}


def count_selects(graph: Graph) -> int:
    """Mask/remask passes in the run: ``where`` ops, the port's remask
    (``DsArray._remask``) and user selects, but none that a helper tagged
    as its own work (``kernels._record.scoped``: the saturating cast's
    three, which the reference's cast does not have, and the sparse
    contraction's index selects, which its ``bcoo_dot_general`` does not)."""
    return sum(1 for n in walk(graph) if n.name == "where" and not n.scope)


def dense_operand_intermediates(graph: Graph, dense_shape) -> List[tuple]:
    """Writes at least as big as the densified sparse operand whose
    trailing dims are its block shape — the signature of a todense()."""
    gn, gm, bn, bm = dense_shape
    full = gn * gm * bn * bm
    bad = []
    for n in walk(graph):
        if not n.writes:
            continue
        for shp in n.shapes:
            if len(shp) >= 2 and tuple(shp[-2:]) == (bn, bm) and \
                    int(np.prod(shp)) >= full:
                bad.append((n.op, shp))
    return bad


def rank2_global_intermediates(graph: Graph, n, m, pn, pm) -> List[tuple]:
    """All rank-2 outputs (views included) whose extent reaches the global
    array size: block-native ops keep grid dims (rank 3/4) or small
    per-axis masks."""
    bad = []
    for node in walk(graph):
        for shp in node.shapes:
            if len(shp) == 2 and shp[0] >= min(n, pn) and \
                    shp[1] >= min(m, pm):
                bad.append((node.op, shp))
    return bad


def full_grid_writes(graph: Graph, shape4) -> List[OpNode]:
    """The nodes that write a full-grid ``shape4`` tensor, but the one that
    writes a single-output run's result: the port's counterpart of the
    reference's non-parameter, non-ROOT ENTRY defs (``entry_full_grid_defs``).
    Inputs are no ops, views are no writes; with several outputs every
    output's write counts, as every root's def does in a tuple-rooted
    ENTRY."""
    shape4 = tuple(shape4)
    return [n for n in walk(graph)
            if n.writes and shape4 in n.shapes
            and not (n.output and graph.n_outputs == 1)]


# ---------------------------------------------------------------------------
# Assertion wrappers (the public test-facing form of the lint rules)
# ---------------------------------------------------------------------------


def assert_no_densify(graph: Graph, dense_shape, msg: str = "") -> None:
    """Rule ``no-densify``, graph plane: no write shaped like the densified
    form of the ``dense_shape``-blocked sparse operand."""
    bad = dense_operand_intermediates(graph, dense_shape)
    assert not bad, (f"sparse operand densified: {bad}"
                     + (f" ({msg})" if msg else ""))


def assert_no_global_intermediate(graph: Graph, n, m, pn, pm) -> None:
    """Rule ``no-full-grid-intermediate``, rank-2 form: no global-extent
    rank-2 tensor anywhere in the run (block-native ops keep grid dims)."""
    bad = rank2_global_intermediates(graph, n, m, pn, pm)
    assert not bad, f"global-shape intermediates produced: {bad}"


def assert_fused_single_body(plan, shape4) -> None:
    """Rule ``no-full-grid-intermediate`` for a fully fused plan: its run
    lowers one plan node (one composed body; leaves dispatch nothing) and
    writes the full-grid shape only as its result.  A fused chain of
    several torch ops writes each op's output (``ROADMAP.md`` §3)."""
    g = plan.graph()
    owners = {n.owner for n in walk(g)}
    assert len(owners) == 1, f"ops of {len(owners)} plan nodes: {owners}"
    bad = full_grid_writes(g, shape4)
    assert not bad, ("intermediate full-grid writes in the run: "
                     + ", ".join(str(n) for n in bad))
