"""Cost-model-attributed plan profiling: predicted vs measured, per node
(the port of ``repro.obs.profiler``).

:func:`profile` runs a plan's optimized DAG node by node, in the order the
plan's run evaluates it (``plan.emission_order``), each ``lower`` fenced
with ``torch.cuda.synchronize`` when its output is on the card, and pairs,
per node,

* **measured time** of that node's dispatch (device time included: the
  fence ends it);
* **measured bytes** of its actual output buffers (a dense stacked
  tensor's bytes; a stacked COO's ``data`` plus its ``indices``; a 0-d
  result's element);
* **predicted bytes** from the ``costmodel`` laws the liveness analysis
  uses (``analysis.liveness.node_output_bytes`` ->
  ``costmodel.node_live_bytes``).

The report also times the fused whole-plan execution (the per-node sum
against one cached run) and, on the card, the whole run's memory:
``argument_bytes`` (the leaves), ``output_bytes`` and ``temp_bytes`` (the
peak allocated over the run's start, less the outputs), the counterpart of
the reference's XLA ``memory_analysis()``.  On the CPU ``compiled`` is
``{}``, as the reference's CPU backend gives.

Nodes whose measured/predicted ratio falls outside
``costmodel.COSTMODEL_DRIFT_FACTOR`` are *drifting*.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import costmodel, expr as _expr, plan as _plan
from repro_torch.core.dsarray import DsArray
from repro_torch.core.expr import ArrayLeaf, Expr, Leaf
from repro_torch.core.sparse import StackedCOO


def _as_plan(target) -> "_plan.Plan":
    if isinstance(target, _plan.Plan):
        return target
    items = target if isinstance(target, (list, tuple)) else [target]
    roots = []
    for t in items:
        if isinstance(t, (_expr.LazyDsArray, _expr.LazyScalar)):
            roots.append(t.expr)
        elif isinstance(t, Expr):
            roots.append(t)
        elif isinstance(t, DsArray):
            roots.append(Leaf(t))
        else:
            raise TypeError(f"cannot profile {type(t).__name__}: expected "
                            "a Plan, lazy expression, Expr or DsArray")
    return _plan.Plan(roots)


def _tensors(val):
    """The tensors holding one value's data (a DsArray's blocks, a stacked
    COO's data and indices)."""
    if isinstance(val, DsArray):
        val = val.blocks
    if isinstance(val, StackedCOO):
        return [val.data, val.indices]
    if isinstance(val, (tuple, list)):
        return [t for v in val for t in _tensors(v)]
    return [val] if isinstance(val, torch.Tensor) else []


def _measured_bytes(val) -> int:
    """Actual bytes of one node's output buffers."""
    ts = _tensors(val)
    if ts:
        return sum(t.numel() * t.element_size() for t in ts)
    return int(np.asarray(val).nbytes)


def _card(val) -> Optional[torch.device]:
    """The card ``val`` lives on, or None on the CPU."""
    return next((t.device for t in _tensors(val) if t.device.type == "cuda"),
                None)


def _block(val) -> None:
    """Wait for the card when ``val`` lives on it (a no-op on the CPU)."""
    dev = _card(val)
    if dev is not None:
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class NodeProfile:
    """One plan node's measured-vs-predicted record."""

    site: str                  # "Kind[key]#nID", the analysis site label
    kind: str                  # node class name
    time_s: float              # fenced wall time of this node's dispatch
    measured_bytes: int        # actual output buffer bytes
    predicted_bytes: int       # costmodel law prediction for the same node

    @property
    def ratio(self) -> float:
        if self.predicted_bytes <= 0:
            return float("inf") if self.measured_bytes else 1.0
        return self.measured_bytes / self.predicted_bytes

    def within(self, factor: Optional[float] = None) -> bool:
        return costmodel.costmodel_drift_ok(
            self.predicted_bytes, self.measured_bytes,
            factor if factor is not None
            else costmodel.COSTMODEL_DRIFT_FACTOR)


@dataclasses.dataclass
class ProfileReport:
    """Per-node records + whole-plan timings for one profiled execution."""

    nodes: List[NodeProfile]
    eager_total_s: float                 # sum of per-node dispatch times
    fused_time_s: Optional[float]        # one fenced cached execution
    compiled: Dict[str, int]             # the fused run's memory, on the card

    def drifting(self, factor: Optional[float] = None) -> List[NodeProfile]:
        return [n for n in self.nodes if not n.within(factor)]

    def __str__(self) -> str:
        lines = [f"{'node':<44}{'time':>10}{'measured':>14}"
                 f"{'predicted':>14}{'ratio':>8}"]
        for n in self.nodes:
            lines.append(f"{n.site[:43]:<44}{n.time_s * 1e3:>8.2f}ms"
                         f"{n.measured_bytes:>14,}{n.predicted_bytes:>14,}"
                         f"{n.ratio:>8.2f}")
        lines.append(f"per-node total {self.eager_total_s * 1e3:.2f}ms"
                     + (f"; fused {self.fused_time_s * 1e3:.2f}ms"
                        if self.fused_time_s is not None else ""))
        if self.compiled:
            lines.append("compiled: " + ", ".join(
                f"{k}={v:,}" for k, v in self.compiled.items()))
        drift = self.drifting()
        lines.append(f"{len(drift)} node(s) beyond "
                     f"{costmodel.COSTMODEL_DRIFT_FACTOR}x drift tolerance"
                     if drift else "all nodes within drift tolerance")
        return "\n".join(lines)


def _compiled_memory(plan: "_plan.Plan") -> Dict[str, int]:
    """The whole run's memory on the card, from one uncounted run of the
    plan's run callable: the leaves' bytes, the outputs' bytes, and the
    peak allocated over the run's start less the outputs.  ``{}`` when the
    leaves are on the CPU."""
    vals = plan.leaf_values()
    dev = _card(vals)
    if dev is None:
        return {}
    run = plan._make_run()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with _expr.suspend_lazy():
        out = run(*vals)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    out_bytes = _measured_bytes(out)
    return {"argument_bytes": _measured_bytes(vals),
            "output_bytes": out_bytes,
            "temp_bytes": max(0, peak - out_bytes)}


def profile(target, *, fused: bool = True,
            compiled: bool = True) -> ProfileReport:
    """Predicted-vs-measured cost report for one plan execution.

    ``fused=False`` skips the whole-plan timing, ``compiled=False`` the
    memory of the fused run.
    """
    # imported here: liveness imports core.plan, which imports
    # repro_torch.obs, whose namespace must finish loading first
    from repro_torch.analysis.liveness import node_output_bytes

    p = _as_plan(target)
    order = _plan.emission_order(p.roots)
    ids = {id(n): f"n{i}" for i, n in enumerate(order)}
    memo: Dict[int, object] = {}
    records: List[NodeProfile] = []
    with _expr.suspend_lazy():
        for node in order:
            if isinstance(node, (Leaf, ArrayLeaf)):
                memo[id(node)] = node.value
                continue
            args = [memo[id(c)] for c in node.children]
            t0 = time.perf_counter()
            out = node.lower(*args)
            _block(out)
            dt = time.perf_counter() - t0
            memo[id(node)] = out
            records.append(NodeProfile(
                site=f"{node.describe()}#{ids[id(node)]}",
                kind=type(node).__name__,
                time_s=dt,
                measured_bytes=_measured_bytes(out),
                predicted_bytes=int(node_output_bytes(node))))
    fused_s = None
    if fused:
        p.execute()                      # warm: the run built outside the timing
        t0 = time.perf_counter()
        _block(p.execute())
        fused_s = time.perf_counter() - t0
    return ProfileReport(
        nodes=records,
        eager_total_s=sum(r.time_s for r in records),
        fused_time_s=fused_s,
        compiled=_compiled_memory(p) if compiled else {})
