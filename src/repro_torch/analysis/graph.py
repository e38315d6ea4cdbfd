"""Plan inspection view: one object giving every rule both analysis planes
(the port of ``repro.analysis.graph``).

``PlanView.of(target)`` coerces whatever the caller has — a ``Plan``, a
``LazyDsArray``/``LazyScalar``, a raw ``Expr``, a concrete ``DsArray`` or a
sequence of any of those — into a :class:`PlanView` holding:

* the **plan plane**: the raw (pre-optimization) roots and the optimized
  DAG, each enumerable in the naive emission order (``plan.emission_order``,
  the exact child-first DFS ``Plan._make_run`` evaluates in), with stable
  per-plan node ids ``n0, n1, ...`` assigned in that order;
* the **graph plane**: the ops of one run of the plan (``Plan.graph()``,
  :mod:`repro_torch.analysis.graphs`).  It takes the place of the
  reference's jaxpr and optimized-HLO pair: the port has no compiler
  between the trace and the run, so what the run dispatches is what the
  card writes;
* the **profile plane**: per-node measured-vs-predicted bytes.

Each plane is computed lazily and memoized — rules that only look at the
DAG never pay for a run.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core import expr as _expr
from repro_torch.core import plan as _plan
from repro_torch.core.dsarray import DsArray
from repro_torch.core.expr import Expr


class PlanView:
    """Cached inspection facets of one plan (see module docstring)."""

    def __init__(self, plan: "_plan.Plan"):
        self.plan = plan
        self._order: Optional[List[Expr]] = None
        self._raw_order: Optional[List[Expr]] = None
        self._ids: Optional[Dict[int, str]] = None
        self._graph = None
        self._profile = None

    # -- coercion ------------------------------------------------------------
    @classmethod
    def of(cls, target) -> "PlanView":
        if isinstance(target, cls):
            return target
        if isinstance(target, _plan.Plan):
            return cls(target)
        items = target if isinstance(target, (list, tuple)) else [target]
        roots = []
        for t in items:
            if isinstance(t, (_expr.LazyDsArray, _expr.LazyScalar)):
                roots.append(t.expr)
            elif isinstance(t, Expr):
                roots.append(t)
            elif isinstance(t, DsArray):
                roots.append(_expr.Leaf(t))
            else:
                raise TypeError(
                    f"cannot analyze {type(t).__name__}: expected a Plan, "
                    "lazy expression, Expr or DsArray")
        return cls(_plan.Plan(roots))

    # -- plan plane ----------------------------------------------------------
    @property
    def roots(self) -> List[Expr]:
        return self.plan.roots

    @property
    def raw_roots(self) -> List[Expr]:
        return self.plan.raw_roots

    @property
    def nodes(self) -> List[Expr]:
        """Post-optimization nodes in naive emission order."""
        if self._order is None:
            self._order = _plan.emission_order(self.plan.roots)
        return self._order

    @property
    def raw_nodes(self) -> List[Expr]:
        """Pre-optimization (as-recorded) nodes in emission order."""
        if self._raw_order is None:
            self._raw_order = _plan.emission_order(self.plan.raw_roots)
        return self._raw_order

    def node_id(self, node: Expr) -> str:
        """Stable per-plan id: position in the post-opt emission order."""
        if self._ids is None:
            self._ids = {id(n): f"n{i}" for i, n in enumerate(self.nodes)}
        return self._ids.get(id(node), "n?")

    def label(self, node: Expr) -> str:
        """Stable site label for findings: ``Kind[key]#id``."""
        return f"{node.describe()}#{self.node_id(node)}"

    def consumers(self) -> Dict[int, int]:
        """Consumer-edge counts per post-opt node id() (roots add one use)."""
        counts: Dict[int, int] = {}
        for n in self.nodes:
            for c in n.children:
                counts[id(c)] = counts.get(id(c), 0) + 1
        for r in self.roots:
            counts[id(r)] = counts.get(id(r), 0) + 1
        return counts

    # -- graph plane ---------------------------------------------------------
    def graph(self):
        """The ops of one run of the plan (:meth:`Plan.graph`; costs one
        execution on the leaves' device).  Each op's ``owner`` indexes
        :attr:`nodes`."""
        if self._graph is None:
            self._graph = self.plan.graph()
        return self._graph

    # -- profile plane -------------------------------------------------------
    def profile(self):
        """Per-node measured-vs-predicted cost records
        (:class:`repro_torch.obs.profiler.ProfileReport`) — costs one
        per-node EXECUTION of the plan, so rules should declare
        ``"profile"`` in ``needs``.  The whole-plan fused timing and the
        run's memory are skipped: the drift check only needs the byte
        pairs."""
        if self._profile is None:
            from repro_torch.obs.profiler import profile as _profile
            self._profile = _profile(self.plan, fused=False, compiled=False)
        return self._profile
