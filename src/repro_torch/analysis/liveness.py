"""Peak-HBM liveness of a plan under a static execution order (the port of
``repro.analysis.liveness``; on the card "HBM" is the H100's device memory).

The multi-host ROADMAP item needs exactly what dask's ``order.py`` computes
for its scheduler: a topological order over the task graph that keeps the
live set small, so executing a plan never spikes HBM by holding every
intermediate at once.  This module computes, from the ``costmodel`` byte
laws:

* the live-set peak under the **naive emission order** — the child-first
  DFS ``Plan._make_run`` actually evaluates (``plan.emission_order``);
* a **liveness-minimizing order** via generalized Sethi–Ullman numbering:
  every node is assigned the peak bytes its subtree needs, and the DFS
  visits children in descending need — the child that needs the most space
  runs while the fewest siblings are held.

Plan inputs (leaves) are caller-held for the whole execution, so they are a
constant baseline added to both peaks; the orders differ only in how long
intermediates stay alive.  ``costmodel.liveness_reorder_pays`` says when the
gap is worth acting on (the ``peak-hbm-liveness`` rule flags at >= 2x).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core import costmodel
from repro_torch.core import plan as _plan
from repro_torch.core.expr import ArrayLeaf, Expr, Leaf, _is_ds, _is_sparse


def _is_input(node: Expr) -> bool:
    return isinstance(node, (Leaf, ArrayLeaf, _plan._Input))


def node_output_bytes(node: Expr) -> int:
    """Resident HBM bytes of one plan node's output, from its meta and the
    ``costmodel`` byte laws (dense stacked tensor / stacked BCOO)."""
    meta = node.meta
    if _is_ds(meta):
        gn, gm, bn, bm = meta.blocks.shape
        if _is_sparse(meta):
            e, nse = meta.blocks.data.element_size(), meta.blocks.nse
        else:
            e, nse = meta.blocks.element_size(), None
        return int(costmodel.node_live_bytes((gn, gm, bn, bm), e, nse=nse))
    return int(meta.numel()) * meta.element_size() if meta.dim() \
        else meta.element_size()


def _consumer_edges(nodes: Sequence[Expr],
                    roots: Sequence[Expr]) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for n in nodes:
        for c in n.children:
            counts[id(c)] = counts.get(id(c), 0) + 1
    for r in roots:
        counts[id(r)] = counts.get(id(r), 0) + 1   # outputs stay live
    return counts


def simulate_peak(order: Sequence[Expr],
                  roots: Sequence[Expr]) -> Tuple[int, int]:
    """(peak live bytes, input baseline bytes) of executing ``order``.

    A node's output becomes live when it executes and dies when its last
    consumer has executed; inputs and roots are live throughout.
    """
    remaining = _consumer_edges(order, roots)
    input_bytes = sum(node_output_bytes(n) for n in order if _is_input(n))
    live = input_bytes
    peak = live
    alive: Dict[int, int] = {}
    for n in order:
        if _is_input(n):
            continue
        b = node_output_bytes(n)
        alive[id(n)] = b
        live += b
        peak = max(peak, live)
        for c in n.children:
            remaining[id(c)] -= 1
            if remaining[id(c)] == 0 and id(c) in alive:
                live -= alive.pop(id(c))
    return peak, input_bytes


def minimized_order(roots: Sequence[Expr]) -> List[Expr]:
    """Liveness-minimizing topological order (dask-``order.py`` style).

    Generalized Sethi–Ullman: need(n) = the peak bytes evaluating n's
    subtree requires when its children are evaluated needy-first.  The DFS
    then emits children in descending need.  On DAGs with sharing the
    numbering is a (sound) over-estimate; the emitted order is always a
    valid topological order.
    """
    need: Dict[int, int] = {}

    def compute_need(n: Expr) -> int:
        if id(n) in need:
            return need[id(n)]
        if _is_input(n):
            need[id(n)] = 0            # inputs are part of the baseline
            return 0
        kids = sorted(n.children, key=compute_need, reverse=True)
        held = 0
        peak = 0
        for c in kids:
            peak = max(peak, held + compute_need(c))
            held += 0 if _is_input(c) else node_output_bytes(c)
        need[id(n)] = max(peak, held + node_output_bytes(n))
        return need[id(n)]

    for r in roots:
        compute_need(r)

    out: List[Expr] = []
    seen = set()

    def emit(n: Expr) -> None:
        if id(n) in seen:
            return
        seen.add(id(n))
        for c in sorted(n.children, key=lambda c: need[id(c)], reverse=True):
            emit(c)
        out.append(n)

    for r in sorted(roots, key=lambda r: need[id(r)], reverse=True):
        emit(r)
    return out


@dataclasses.dataclass(frozen=True)
class LivenessReport:
    """Naive-vs-minimized peak live bytes for one plan."""

    naive_peak: int
    minimized_peak: int
    input_bytes: int
    n_nodes: int

    @property
    def ratio(self) -> float:
        return self.naive_peak / self.minimized_peak \
            if self.minimized_peak else 1.0

    @property
    def reorder_pays(self) -> bool:
        return costmodel.liveness_reorder_pays(self.naive_peak,
                                               self.minimized_peak)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (f"peak HBM live bytes: naive={self.naive_peak:,} "
                f"minimized={self.minimized_peak:,} "
                f"(ratio {self.ratio:.2f}x, inputs {self.input_bytes:,})")


def analyze(roots: Sequence[Expr]) -> LivenessReport:
    naive = _plan.emission_order(roots)
    naive_peak, input_bytes = simulate_peak(naive, roots)
    ordered = minimized_order(roots)
    min_peak, _ = simulate_peak(ordered, roots)
    # the numbering is a heuristic: never report a "minimized" order that is
    # actually worse than what the runtime already does
    min_peak = min(min_peak, naive_peak)
    return LivenessReport(naive_peak=naive_peak, minimized_peak=min_peak,
                          input_bytes=input_bytes, n_nodes=len(naive))
