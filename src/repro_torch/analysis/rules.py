"""The lint rules: small classes registered under stable ids (the port of
``repro.analysis.rules``: the same ids, severities and budgets).

Each rule inspects one or two planes of a :class:`~repro_torch.analysis.
graph.PlanView` and returns :class:`Finding`s.  Planes are declared via
``needs`` so a caller can see what a rule costs: ``"plan"`` is free
(DAG walk), ``"graph"`` pays one run of the plan (``Plan.graph()``, the
port's one plane in place of the reference's ``"jaxpr"`` and ``"hlo"``),
``"profile"`` one per-node run.  Rules that would need an expensive plane
but can prove from the DAG alone that nothing can fire skip it (e.g.
``no-densify`` never runs a plan with no sparse nodes).

Rule ids, one line each:

``no-densify``            sparse values only densify through explicit nodes
``no-full-grid-intermediate``  fused bodies write no extra full-grid tensors
``pad-soundness``         claimed pad_state never stronger than derivable
``remask-budget``         select passes stay within the costmodel budget
``recompile-hazard``      recordings whose plan-cache key cannot be stable
``peak-hbm-liveness``     naive vs liveness-minimized peak device memory
                          (info; warn when reordering saves >= 2x)
``costmodel-drift``       measured per-node output bytes stay within the
                          costmodel byte laws' tolerance (pays one per-node
                          execution — the "profile" plane)
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Type

import numpy as np

from repro_torch.core import costmodel
from repro_torch.core.expr import (Blockwise, ConcatRows, Densify, GetItem,
                                   MatMul, PadGrid, Rechunk, Reduce, Shuffle,
                                   ToSparse, Transpose, _is_ds, _is_sparse)
from repro_torch.analysis import graphs, liveness
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graph import PlanView

_REGISTRY: Dict[str, Type["Rule"]] = {}


def register(cls: Type["Rule"]) -> Type["Rule"]:
    assert cls.id not in _REGISTRY, f"duplicate rule id {cls.id}"
    _REGISTRY[cls.id] = cls
    return cls


def all_rule_ids() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_rules(ids=None) -> List["Rule"]:
    if ids is None:
        return [cls() for cls in _REGISTRY.values()]
    unknown = [i for i in ids if i not in _REGISTRY]
    if unknown:
        raise ValueError(f"unknown rule ids {unknown}; "
                         f"known: {sorted(_REGISTRY)}")
    return [_REGISTRY[i]() for i in ids]


class Rule:
    """One lint rule: ``run(view)`` returns findings for one plan."""

    id: str = "?"
    severity: str = "error"
    needs: Tuple[str, ...] = ("plan",)

    def run(self, view: PlanView) -> List[Finding]:
        raise NotImplementedError

    def finding(self, site: str, message: str, severity: str = None,
                data: tuple = ()) -> Finding:
        return Finding(rule=self.id, severity=severity or self.severity,
                       site=site, message=message, data=data)


# ---------------------------------------------------------------------------


#: nodes a sparse value may legally flow into without a finding: Densify is
#: the explicit claim, MatMul/Reduce consume a stacked COO natively
#: (``sparse_contract`` / entry reduction), ToSparse/Canonicalize are
#: format ops.
_SPARSE_SINKS = (Densify, MatMul, Reduce, ToSparse)
#: structural ops whose sparse handling is documented to go through dense.
_DOCUMENTED_DENSIFY = (GetItem, Rechunk, ConcatRows, Shuffle, Transpose,
                       PadGrid)


@register
class NoDensify(Rule):
    """A stacked-COO value never flows through a densifying op unless an
    explicit ``Densify`` node claims the conversion (the paper's sparse wins
    die the moment a chain silently materializes the dense form)."""

    id = "no-densify"
    severity = "error"
    needs = ("plan", "graph")

    def run(self, view: PlanView) -> List[Finding]:
        out: List[Finding] = []
        flagged: set = set()
        sparse_nodes = [n for n in view.nodes if _is_sparse(n.meta)]
        for n in view.nodes:
            if not (_is_ds(n.meta) and not _is_sparse(n.meta)):
                continue
            if not any(_is_sparse(c.meta) for c in n.children):
                continue
            if isinstance(n, _SPARSE_SINKS):
                continue
            if isinstance(n, _DOCUMENTED_DENSIFY):
                out.append(self.finding(
                    view.label(n), "sparse operand goes through the "
                    "documented dense path of a structural op",
                    severity="info"))
                flagged.add(id(n))
                continue
            out.append(self.finding(
                view.label(n),
                f"{n.kind} consumes a bcoo operand but produces a dense "
                "result without an explicit Densify node claiming the "
                "conversion"))
            flagged.add(id(n))
        if not sparse_nodes:
            return out
        # graph plane: writes shaped like the densified sparse operand that
        # no legitimate dense node accounts for
        claimed = {tuple(n.meta.blocks.shape) for n in view.nodes
                   if _is_ds(n.meta) and not _is_sparse(n.meta)
                   and id(n) not in flagged}
        seen: set = set()
        for sp in sparse_nodes:
            shape4 = tuple(sp.meta.blocks.shape)
            if shape4 in seen or shape4 in claimed:
                continue
            seen.add(shape4)
            hits = graphs.dense_operand_intermediates(view.graph(), shape4)
            for op, shp in hits:
                if tuple(shp) in claimed:
                    continue
                out.append(self.finding(
                    f"op:{op}{list(shp)}",
                    f"the run materializes a dense {list(shp)} value from a "
                    f"stacked-COO operand blocked {list(shape4)} with no "
                    "Densify node in the plan"))
        return out


#: the site of a full-grid finding whose every write beyond the budget is
#: one step's output inside a fused Blockwise's composed body: the eager
#: composition's deviation (``ROADMAP.md`` §3), the only one that carries
#: no shape, so that one waiver token names it at every size
FUSED_STEP_OUTPUTS = "entry:fused-step-outputs"


def _is_fused(node) -> bool:
    key = getattr(node, "key", None)
    return isinstance(node, Blockwise) and isinstance(key, tuple) \
        and bool(key) and key[0] == "fused"


def _beyond_step_outputs(view: PlanView, defs, own: Dict[int, int]) -> int:
    """The writes beyond the budget that no fused step's own output
    explains: every extra write of a node that is no fused Blockwise (or of
    no node), and in a fused body each write past the first of one step
    (an intermediate inside the step, as a sort is)."""
    by_owner: Dict[object, list] = {}
    for d in defs:
        by_owner.setdefault(d.owner, []).append(d)
    beyond = 0
    for i, ds in by_owner.items():
        extra = len(ds) - own.get(i, 0)
        if extra <= 0:
            continue
        if i is None or not _is_fused(view.nodes[i]):
            beyond += extra
            continue
        per_step: Dict[int, int] = {}
        for d in ds:
            per_step[d.step] = per_step.get(d.step, 0) + 1
        inside = sum(k if s == 0 else k - 1 for s, k in per_step.items())
        beyond += min(extra, inside)
    return beyond


@register
class NoFullGridIntermediate(Rule):
    """No full-grid write in the plan's run beyond what the plan's
    surviving nodes account for — the reference's ENTRY-def budget, read on
    the run's graph (``graphs.full_grid_writes``).

    The budget and the site are the reference's: per full-grid shape, one
    write for each surviving non-root node of that shape, plus each root's
    with several roots; the site ``entry:[gn, gm, bn, bm]``.  One case is
    told apart: a fused Blockwise is one composed function of eager torch
    ops, each step writing its output (``ROADMAP.md`` §3).  When every
    write beyond the budget is such a step output, the finding's site is
    :data:`FUSED_STEP_OUTPUTS`; a step that writes more than its output, or
    an extra write of any other node, keeps the reference's site."""

    id = "no-full-grid-intermediate"
    severity = "error"
    needs = ("plan", "graph")

    def run(self, view: PlanView) -> List[Finding]:
        dense_bw = [n for n in view.nodes
                    if isinstance(n, Blockwise) and _is_ds(n.meta)
                    and not _is_sparse(n.meta)]
        if not dense_bw:
            return []        # nothing fusible: skip the run
        shapes = {tuple(n.meta.blocks.shape) for n in dense_bw}
        roots = {id(r) for r in view.roots}
        g = view.graph()
        out: List[Finding] = []
        for shape4 in sorted(shapes):
            # every surviving non-root node of this shape legitimately
            # materializes once; with several roots each root's write also
            # counts (the run returns them all)
            own = {i: 1 for i, n in enumerate(view.nodes)
                   if id(n) not in roots and n.children
                   and _is_ds(n.meta) and not _is_sparse(n.meta)
                   and tuple(n.meta.blocks.shape) == shape4}
            if len(view.roots) > 1:
                own.update({i: 1 for i, n in enumerate(view.nodes)
                            if id(n) in roots and _is_ds(n.meta)
                            and not _is_sparse(n.meta)
                            and tuple(n.meta.blocks.shape) == shape4})
            budget = sum(own.values())
            defs = graphs.full_grid_writes(g, shape4)
            if len(defs) > budget:
                steps_only = not _beyond_step_outputs(view, defs, own)
                out.append(self.finding(
                    FUSED_STEP_OUTPUTS if steps_only
                    else f"entry:{list(shape4)}",
                    f"{len(defs)} full-grid {list(shape4)} writes in the "
                    f"run but the plan accounts for {budget} — "
                    + ("each step of a fused body writes its output "
                       if steps_only else "an intermediate is being "
                       "materialized inside a fused chain ")
                    + f"(first: {defs[0]})",
                    data=(len(defs), budget)))
        return out


@register
class PadSoundness(Rule):
    """Abstract-interpret pad state with the same probe the recorder uses
    and flag any node whose CLAIMED pad_state is stronger than the derived
    one — a wrong zero/fill claim makes every downstream mask elision
    unsound."""

    id = "pad-soundness"
    severity = "error"
    needs = ("plan",)

    def run(self, view: PlanView) -> List[Finding]:
        out: List[Finding] = []
        for n in view.nodes:
            if not isinstance(n, Blockwise) or not _is_ds(n.meta):
                continue
            if _is_sparse(n.meta):
                continue     # bcoo results are zero-padded by construction
            claim = n.pad
            derived = n._probe_pad()
            if claim == derived:
                continue
            if claim.kind == "dirty":
                continue     # weaker than derivable: sound, never flagged
            if derived.kind == "dirty":
                out.append(self.finding(
                    view.label(n),
                    f"claims pad_state {claim} but the probe cannot derive "
                    "it (derived DIRTY): the claim is stronger than the "
                    "transfer rules support",
                    data=(str(claim), str(derived))))
            else:
                out.append(self.finding(
                    view.label(n),
                    f"claims pad_state {claim} but the probe derives "
                    f"{derived}: mask elision downstream would read wrong "
                    "pad values",
                    data=(str(claim), str(derived))))
        return out


#: consumers that may pay one deferred remask per ds operand
#: (``costmodel.chain_remask_passes(1, pad_tracked=True,
#: zero_preserving=False) == 1``).
_REMASK_CONSUMERS = (MatMul, Reduce, GetItem, Rechunk, ConcatRows, Shuffle,
                     Densify, ToSparse)


@register
class RemaskBudget(Rule):
    """Count mask/select passes in the trace against the costmodel budget:
    one deferred pass per ds operand of each pad-sensitive consumer, plus
    one per root materialization — the pad-state tracking contract."""

    id = "remask-budget"
    severity = "warn"
    needs = ("plan", "graph")

    def run(self, view: PlanView) -> List[Finding]:
        per_consumer = costmodel.chain_remask_passes(
            1, pad_tracked=True, zero_preserving=False)
        budget = len(view.roots) * per_consumer
        for n in view.nodes:
            if isinstance(n, _REMASK_CONSUMERS):
                budget += per_consumer * sum(
                    1 for c in n.children if _is_ds(c.meta))
        count = graphs.count_selects(view.graph())
        if count <= budget:
            return []
        return [self.finding(
            "plan",
            f"{count} select/mask passes in the run exceed the remask "
            f"budget of {budget} (one deferred pass per pad-sensitive "
            "consumer operand + one per root)",
            data=(count, budget))]


def _iter_key_atoms(key):
    if isinstance(key, tuple):
        for k in key:
            yield from _iter_key_atoms(k)
    else:
        yield key


def _scalar_atoms(key):
    """(value, dtype-str) pairs as baked by ``expr._scalar_key``: the
    port keys a Python scalar by its type's name (``int``, ``float``,
    ``bool``), given here as NumPy's name for it (``int64``, ...), as the
    reference's ``np.asarray(v).dtype`` gives it."""
    if isinstance(key, tuple):
        if len(key) == 2 and isinstance(key[0], (bool, int, float)) \
                and isinstance(key[1], str):
            try:
                dt = np.dtype(key[1])
            except TypeError:
                pass
            else:
                yield key[0], dt.name
                return
        for k in key:
            yield from _scalar_atoms(k)


@register
class RecompileHazard(Rule):
    """Plan-cache key instability in the AS-RECORDED DAG: keys that cannot
    match across recordings (fresh lambdas), baked non-static data, and
    scalar operands whose weak-type drift splits the cache."""

    id = "recompile-hazard"
    severity = "warn"
    needs = ("plan",)

    def run(self, view: PlanView) -> List[Finding]:
        out: List[Finding] = []
        scalars: Dict[float, set] = {}
        scalar_site: Dict[float, str] = {}
        for n in view.raw_nodes:
            if not isinstance(n, Blockwise):
                continue
            site = f"{n.describe()}#raw"
            for atom in _iter_key_atoms(n.key):
                if callable(atom) and \
                        getattr(atom, "__name__", "") == "<lambda>":
                    out.append(self.finding(
                        site, "a lambda is baked into the plan key: every "
                        "re-recording creates a fresh function object, so "
                        "the plan cache can never hit (name the "
                        "fn, or pass a stable _key)"))
            for cell in getattr(n.fn, "__closure__", None) or ():
                v = cell.cell_contents
                if getattr(v, "ndim", 0) and not callable(v):
                    out.append(self.finding(
                        site, f"recorded fn closes over a {v.ndim}-D array "
                        f"{tuple(v.shape)}: the data is baked into the "
                        "cached plan instead of being a runtime input "
                        "(thread it through map_blocks operands)"))
            for val, dt in _scalar_atoms(n.key):
                try:
                    fval = float(val)
                except (TypeError, OverflowError):
                    continue
                scalars.setdefault(fval, set()).add(dt)
                scalar_site.setdefault(fval, site)
        for fval, dts in sorted(scalars.items()):
            if len(dts) > 1:
                out.append(self.finding(
                    scalar_site[fval],
                    f"scalar {fval} is baked with {len(dts)} distinct "
                    f"dtypes {sorted(dts)} in one plan: weak-type drift "
                    "(e.g. `2` vs `2.0`) keys separate cache entries for "
                    "the same computation",
                    data=(fval, tuple(sorted(dts)))))
        return out


@register
class PeakHbmLiveness(Rule):
    """Per-node live-set bytes under the naive emission order vs a
    liveness-minimizing topological order (dask ``order.py`` style) from
    the costmodel byte laws (device memory; "HBM" on the H100 too).  Always reports both peaks (info); flags the
    plan (warn) when reordering saves ``PEAK_REORDER_FACTOR``x or more."""

    id = "peak-hbm-liveness"
    severity = "warn"
    needs = ("plan",)

    def run(self, view: PlanView) -> List[Finding]:
        rep = liveness.analyze(view.roots)
        data = (rep.naive_peak, rep.minimized_peak, rep.input_bytes,
                rep.n_nodes)
        if rep.reorder_pays:
            return [self.finding(
                "plan",
                f"naive emission order peaks at {rep.naive_peak:,} live "
                f"bytes; a liveness-minimizing order needs only "
                f"{rep.minimized_peak:,} ({rep.ratio:.2f}x) — reordering "
                "pays (costmodel.PEAK_REORDER_FACTOR)",
                data=data)]
        return [self.finding(
            "plan", str(rep), severity="info", data=data)]


@register
class CostmodelDrift(Rule):
    """Execute the plan node by node (``obs.profile``) and flag any node
    whose MEASURED output bytes land outside the costmodel byte laws'
    tolerance (``costmodel.COSTMODEL_DRIFT_FACTOR``).  The laws are exact
    for both block representations, so drift means a representation or a
    law changed without the other — every liveness/fusion/bucket decision
    derived from the stale side is then wrong.  This is the expensive rule
    (one per-node execution), declared as its own ``"profile"`` plane."""

    id = "costmodel-drift"
    severity = "warn"
    needs = ("plan", "profile")

    def run(self, view: PlanView) -> List[Finding]:
        out: List[Finding] = []
        for rec in view.profile().drifting():
            out.append(self.finding(
                rec.site,
                f"measured output {rec.measured_bytes:,} bytes vs "
                f"costmodel-predicted {rec.predicted_bytes:,} "
                f"({rec.ratio:.2f}x) — beyond the "
                f"{costmodel.COSTMODEL_DRIFT_FACTOR}x drift tolerance; "
                "the byte law and the block representation disagree",
                data=(rec.measured_bytes, rec.predicted_bytes)))
        return out
