"""Optimize, cache and run lazy ds-array plans (the port of
``repro.core.plan``).

``compute()`` takes recorded ``Expr`` DAGs (``core.expr``) through three
stages:

1. **optimize** —
   (a) canonicalize + hash-cons (CSE): identical subexpressions become one
       node, so sibling reductions over one operand evaluate it once and
       duplicate reductions collapse;
   (b) transpose rules: ``T(T(x)) → x``; a Blockwise whose ds operands are
       all transposes hoists the transpose above the elementwise work (so
       chains keep fusing and the fold below can fire);
       ``(Aᵀ) @ B → MatMul(A, B, transpose_a=True)``, which launches the
       GEMM with the transpose read through strides: ``Aᵀ`` is never
       materialised;
   (c) blockwise fusion: runs of elementwise/map_blocks nodes with
       single-consumer intermediates compose into ONE per-block function
       whose pad state is the outer node's resolved one, so a chain pays at
       most one remask, at its consumer.

2. **run** — the optimized DAG, with its leaves replaced by positional
   inputs (``_detach``), becomes one callable (``_make_run``) that lowers
   each node onto the eager primitives.  A fused chain is one composed
   per-block function of torch ops: it saves remasks and shared work, not
   kernel launches (each torch op in it still launches its own).

3. **cache** — run callables are keyed by a structural hash (node kinds,
   static params, leaf signatures, never leaf data), so a hot-loop body
   such as the PCA power iteration builds its run once and replays it
   (``_CACHE``; the reference's ``jax.jit`` compile is this build).  The
   optimizer is cached the same way: a pre-optimization key (which also
   encodes leaf aliasing) maps to the optimized plan key and input order
   (``_OPT_CACHE``), so recording an unchanged DAG again skips the
   optimizer.

Block formats: a sparse ``Blockwise`` (its fn takes or gives a stacked
COO) is a **fusion boundary** — a stacked-COO fn does not compose with
dense per-block fns — but sparse nodes still CSE, and sparse plans cache by
structure and ``nse`` like any other.

Counters (group ``plan``): ``hits``/``misses`` of ``_CACHE``, ``launches``
(plan executions), ``opt_runs``/``opt_skips`` and ``eager_launches``
(:meth:`Plan.execute_eager`).  Spans: ``plan.optimize`` and ``plan.launch``;
the launch span ends after ``torch.cuda.synchronize()`` when the plan ran
on the card, so it times device work, not the enqueue.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import expr as _expr
from repro_torch.core.dsarray import DsArray
from repro_torch.core.sparse import StackedCOO
from repro_torch.core.expr import (ArrayLeaf, Blockwise, Expr, Leaf, MatMul,
                                   Transpose, _is_ds, _is_sparse)
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import tracing as _tracing

# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def _count_nodes(roots: Sequence[Expr]) -> int:
    seen = set()

    def visit(n: Expr) -> None:
        if id(n) in seen:
            return
        seen.add(id(n))
        for c in n.children:
            visit(c)

    for r in roots:
        visit(r)
    return len(seen)


def _rules(n: Expr) -> Expr:
    """Local rewrite rules, applied bottom-up after children are canonical."""
    if isinstance(n, Transpose) and isinstance(n.children[0], Transpose):
        return n.children[0].children[0]
    if isinstance(n, MatMul) and not n.transpose_a \
            and isinstance(n.children[0], Transpose):
        return MatMul(n.children[0].children[0], n.children[1],
                      transpose_a=True)
    if isinstance(n, Blockwise) and n.elementwise and _is_ds(n.meta) \
            and n.children \
            and all(isinstance(c, Transpose) for c in n.children):
        # elementwise only: a position-dependent map_blocks fn does not
        # commute with the block transpose.  Transpose keeps pad constants,
        # so the resolved pad carries over unchanged.
        inner = Blockwise(n.fn, tuple(c.children[0] for c in n.children),
                          ("hoistT", n.key), pad=n.pad, elementwise=True)
        return Transpose(inner)
    return n


def _canonicalize(roots: Sequence[Expr]) -> List[Expr]:
    """Bottom-up rewrite + hash-consing (CSE) over the whole DAG."""
    memo: Dict[int, Expr] = {}
    cons: Dict[tuple, Expr] = {}

    def canon(node: Expr) -> Expr:
        if id(node) in memo:
            return memo[id(node)]
        kids = [canon(c) for c in node.children]
        n2 = node if all(a is b for a, b in zip(kids, node.children)) \
            else node.rebuild(kids)
        n2 = _rules(n2)
        if isinstance(n2, (Leaf, ArrayLeaf)):
            key = (type(n2).__name__, id(n2.value))
        else:
            key = (type(n2).__name__, n2.local_key(),
                   tuple(id(c) for c in n2.children))
        n2 = cons.setdefault(key, n2)
        memo[id(node)] = n2
        return n2

    return [canon(r) for r in roots]


def _use_counts(roots: Sequence[Expr]) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    seen = set()

    def visit(n: Expr) -> None:
        for c in n.children:
            counts[id(c)] = counts.get(id(c), 0) + 1
            if id(c) not in seen:
                seen.add(id(c))
                visit(c)

    for r in roots:
        counts[id(r)] = counts.get(id(r), 0) + 1
        if id(r) not in seen:
            seen.add(id(r))
            visit(r)
    return counts


def _compose(parent_fn, specs):
    """One per-block function for a fused Blockwise: each spec is
    ``("arg", slot)`` (pass an input through) or ``("call", (child_fn,
    slots))`` (inline the child's computation)."""

    def fused(*args):
        vals = []
        for kind, payload in specs:
            if kind == "arg":
                vals.append(args[payload])
            else:
                cfn, idxs = payload
                vals.append(cfn(*[args[i] for i in idxs]))
        return parent_fn(*vals)

    return fused


def _fuse(roots: Sequence[Expr]) -> Tuple[List[Expr], int]:
    """Fuse single-consumer Blockwise chains into composed Blockwise nodes."""
    counts = _use_counts(roots)
    memo: Dict[int, Expr] = {}
    fused_away = 0

    def fuse(node: Expr) -> Expr:
        nonlocal fused_away
        if id(node) in memo:
            return memo[id(node)]
        kids = [fuse(c) for c in node.children]
        out = node if all(a is b for a, b in zip(kids, node.children)) \
            else node.rebuild(kids)
        if isinstance(out, Blockwise) and _is_ds(out.meta):
            specs, new_children, key_parts = [], [], []
            slot_of: Dict[int, int] = {}
            inlined = 0

            def slot(child: Expr) -> int:
                if id(child) not in slot_of:
                    slot_of[id(child)] = len(new_children)
                    new_children.append(child)
                return slot_of[id(child)]

            for orig_c, new_c in zip(node.children, kids):
                # sparse nodes are fusion boundaries: a stacked-COO fn does
                # not inline into a dense per-block body, nor the reverse
                fusible = (isinstance(new_c, Blockwise)
                           and _is_ds(new_c.meta)
                           and not _is_sparse(new_c.meta)
                           and not _is_sparse(out.meta)
                           and not any(_is_sparse(gc.meta)
                                       for gc in new_c.children)
                           and counts.get(id(orig_c), 2) == 1
                           and new_c.meta.blocks.shape == out.meta.blocks.shape
                           and new_c.meta.grid == out.meta.grid)
                if fusible:
                    idxs = [slot(gc) for gc in new_c.children]
                    specs.append(("call", (new_c.fn, idxs)))
                    key_parts.append(("call", new_c.key, tuple(idxs)))
                    inlined += 1
                else:
                    s = slot(new_c)
                    specs.append(("arg", s))
                    key_parts.append(("arg", s))
            if inlined:
                fused_away += inlined
                # the fused node computes what the outer node did, so its pad
                # is the outer node's RESOLVED pad (a re-probe could wrongly
                # upgrade an explicit DIRTY)
                ew = out.elementwise and all(
                    c.elementwise for s, c in zip(specs, kids)
                    if s[0] == "call")
                out = Blockwise(_compose(out.fn, specs), new_children,
                                ("fused", out.key, tuple(key_parts)),
                                pad=out.pad, elementwise=ew)
        memo[id(node)] = out
        return out

    new_roots = [fuse(r) for r in roots]
    return new_roots, fused_away


def optimize(roots: Sequence[Expr]) -> Tuple[List[Expr], Dict[str, int]]:
    before = _count_nodes(roots)
    roots = _canonicalize(roots)
    roots, fused = _fuse(roots)
    # fusion can leave freshly composed siblings identical: re-cons
    roots = _canonicalize(roots)
    after = _count_nodes(roots)
    return roots, {"nodes_before": before, "nodes_after": after,
                   "fused_elementwise": fused}


# ---------------------------------------------------------------------------
# Detached inputs (a cached run never pins leaf DATA alive)
# ---------------------------------------------------------------------------


class _Input(Expr):
    """Positional plan input: only the leaf's static metadata."""

    __slots__ = ("idx", "is_ds", "grid", "pad")

    def __init__(self, leaf: Expr, idx: int):
        self.idx = idx
        self.is_ds = isinstance(leaf, Leaf)
        self.grid = leaf.value.grid if self.is_ds else None
        self.pad = leaf.value.pad_state if self.is_ds else None
        self.children = ()
        self.meta = leaf.meta        # meta tensors: no data

    def bind(self, val):
        return DsArray(val, self.grid, self.pad) if self.is_ds else val

    def rebuild(self, children):
        return self


def _detach(roots: Sequence[Expr], leaves: Sequence[Expr]) -> List[Expr]:
    """The DAG with its Leaf/ArrayLeaf nodes replaced by ``_Input`` stubs,
    so that the cached run refers to no concrete tensor."""
    memo: Dict[int, Expr] = {id(l): _Input(l, i) for i, l in enumerate(leaves)}

    def clone(node: Expr) -> Expr:
        if id(node) not in memo:
            memo[id(node)] = node.rebuild([clone(c) for c in node.children])
        return memo[id(node)]

    return [clone(r) for r in roots]


# ---------------------------------------------------------------------------
# Structural plan keys + the caches
# ---------------------------------------------------------------------------


def _structural_key(roots: Sequence[Expr], aliases: bool
                    ) -> Tuple[tuple, List[Expr]]:
    """Linear structural encoding of the DAG + its ordered leaf list: node
    kinds, static params and leaf SIGNATURES (geometry, dtype, pad state),
    never leaf data.  ``aliases`` adds an alias-group index per input."""
    entries: List[tuple] = []
    index: Dict[int, int] = {}
    leaves: List[Expr] = []
    alias: Dict[int, int] = {}

    def key(node: Expr) -> int:
        if id(node) in index:
            return index[id(node)]
        cids = tuple(key(c) for c in node.children)
        if isinstance(node, (Leaf, ArrayLeaf)):
            leaves.append(node)
            entry = ("input", node.signature())
            if aliases:
                entry += (alias.setdefault(id(node.value), len(alias)),)
        else:
            entry = (type(node).__name__, node.local_key(), cids)
        entries.append(entry)
        index[id(node)] = len(entries) - 1
        return index[id(node)]

    rids = tuple(key(r) for r in roots)
    return (tuple(entries), rids), leaves


def _plan_key(roots: Sequence[Expr]) -> Tuple[tuple, List[Expr]]:
    """Key of an optimized DAG: a plan recorded again on fresh arrays of the
    same signatures reuses the cached run."""
    return _structural_key(roots, aliases=False)


def _preopt_key(roots: Sequence[Expr]) -> Tuple[tuple, List[Expr]]:
    """Key of the RAW (pre-optimization) DAG.  The optimizer CSEs leaves by
    value identity, so two recordings that differ only in whether two uses
    share one array must not collide: each input carries its alias group.
    The optimized plan is a pure function of this key, which is what makes
    skipping the optimizer sound."""
    return _structural_key(roots, aliases=True)


# LRU-bounded: keys can hold user fn objects (map_blocks), so a loop that
# records a FRESH lambda every iteration would otherwise grow the cache
# without bound.
_CACHE: "OrderedDict[tuple, callable]" = OrderedDict()
# pre-optimization key -> (optimized plan key, leaf positions, stats)
_OPT_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_CACHE_MAX = 256
_STATS = _metrics.CounterGroup(
    "plan", ("hits", "misses", "launches", "opt_runs", "opt_skips",
             "eager_launches"))


def cache_stats() -> Dict[str, int]:
    return _STATS.as_dict()


def clear_cache() -> None:
    _CACHE.clear()
    _OPT_CACHE.clear()
    _STATS.reset()


def _bounded_put(cache: OrderedDict, key, value) -> None:
    cache[key] = value
    while len(cache) > _CACHE_MAX:
        cache.popitem(last=False)


# Plan observers: callbacks run on every Plan built (``capture_plans``).
_PLAN_OBSERVERS: List = []


@contextlib.contextmanager
def capture_plans():
    """Collect every ``Plan`` constructed inside the block."""
    captured: List[Plan] = []
    _PLAN_OBSERVERS.append(captured.append)
    try:
        yield captured
    finally:
        _PLAN_OBSERVERS.remove(captured.append)


def _synchronize(out: tuple) -> None:
    """Wait for the card when any result lives on it."""
    for v in out:
        t = v.blocks if isinstance(v, DsArray) else v
        t = t.data if isinstance(t, StackedCOO) else t
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


class Plan:
    """An optimized, cacheable plan over one or more roots.

    The optimizer is skipped when a structurally identical DAG was planned
    before (``_OPT_CACHE``): the cached plan key and input order are reused,
    and the optimized roots are only built on demand (on a ``_CACHE`` miss
    or for inspection).
    """

    def __init__(self, roots: Sequence[Expr]):
        self.stats: Dict[str, int]
        self._raw_roots = list(roots)
        self._roots: Optional[List[Expr]] = None
        pre_key, raw_leaves = _preopt_key(self._raw_roots)
        try:
            cached = _OPT_CACHE.get(pre_key)
        except TypeError:            # unhashable static param: no caching
            pre_key, cached = None, None
        if cached is not None:
            _OPT_CACHE.move_to_end(pre_key)
            _STATS.inc("opt_skips")
            self.key, positions, stats = cached
            self.stats = dict(stats)
            self.leaves = [raw_leaves[p] for p in positions]
        else:
            self._optimize_now(pre_key, raw_leaves)
        for cb in list(_PLAN_OBSERVERS):
            cb(self)

    def _optimize_now(self, pre_key=None, raw_leaves=None) -> None:
        _STATS.inc("opt_runs")
        with _tracing.span("plan.optimize", roots=len(self._raw_roots)):
            opt_roots, self.stats = optimize(self._raw_roots)
        self.key, self.leaves = _plan_key(opt_roots)
        self._roots = opt_roots
        self.stats["n_inputs"] = len(self.leaves)
        if pre_key is None:
            return
        # optimized leaves are a subset of the raw ones (CSE only merges):
        # keep their positions so a later hit binds fresh leaf values
        pos = {id(l): i for i, l in enumerate(raw_leaves)}
        _bounded_put(_OPT_CACHE, pre_key,
                     (self.key, tuple(pos[id(l)] for l in self.leaves),
                      dict(self.stats)))

    @property
    def roots(self) -> List[Expr]:
        if self._roots is None:
            # after an optimizer-cache hit: derive the optimized DAG again;
            # the same structure gives the same key and input order
            self._optimize_now()
        return self._roots

    def _make_run(self):
        detached = _detach(self.roots, self.leaves)
        n_inputs = len(self.leaves)

        def run(*vals):
            if len(vals) != n_inputs:
                raise ValueError(f"plan takes {n_inputs} inputs, got {len(vals)}")
            memo: Dict[int, object] = {}

            def ev(node: Expr):
                nid = id(node)
                if nid not in memo:
                    memo[nid] = (node.bind(vals[node.idx])
                                 if isinstance(node, _Input)
                                 else node.lower(*[ev(c) for c in node.children]))
                return memo[nid]

            return tuple(ev(r) for r in detached)

        return run

    def leaf_values(self) -> List[torch.Tensor]:
        return [l.value.blocks if isinstance(l, Leaf) else l.value
                for l in self.leaves]

    def _launch(self, run, mode: str, **attrs) -> tuple:
        with _expr.suspend_lazy():
            if not _tracing.enabled():
                return run(*self.leaf_values())
            with _tracing.span("plan.launch", mode=mode,
                               inputs=len(self.leaves), **attrs):
                out = run(*self.leaf_values())
                _synchronize(out)
            return out

    def execute(self) -> tuple:
        """Run the plan through its cached run callable (built on a miss)."""
        run = _CACHE.get(self.key)
        cached = run is not None
        if cached:
            _STATS.inc("hits")
            _CACHE.move_to_end(self.key)
        else:
            _STATS.inc("misses")
            run = self._make_run()
            _bounded_put(_CACHE, self.key, run)
        _STATS.inc("launches")
        return self._launch(run, "fused", cached=cached)

    def execute_eager(self) -> tuple:
        """Run the plan node by node through a fresh run callable, bypassing
        the cache; the results equal :meth:`execute`'s."""
        _STATS.inc("eager_launches")
        return self._launch(self._make_run(), "eager")


def _roots_of(exprs) -> List[Expr]:
    return [e.expr if isinstance(e, (_expr.LazyDsArray, _expr.LazyScalar))
            else e for e in exprs]


def compute_multi(*exprs) -> tuple:
    """Evaluate several recorded expressions as ONE plan: CSE runs across
    the roots, so sibling reductions over one operand share a single
    evaluation of it (the paper's shared task graph)."""
    return Plan(_roots_of(exprs)).execute()


def compute(e):
    """Evaluate one recorded expression; a DsArray for a ds-shaped plan, a
    0-d tensor for a scalar one."""
    return compute_multi(e)[0]


def plan_for(*exprs) -> Plan:
    """The optimized Plan (stats, roots) without running it."""
    return Plan(_roots_of(exprs))
