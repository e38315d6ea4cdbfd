"""Lazy expression IR for ds-array op chains: record now, optimize and fuse
later (the port of ``repro.core.expr``).

The paper's ds-array is lazy by construction: every op is a PyCOMPSs task
returning futures, and the runtime sees the whole task graph before anything
runs.  Here ops are **recorded** as ``Expr`` nodes behind a
:class:`LazyDsArray` facade that mirrors the ``DsArray`` API, and
``compute()`` (``core.plan``) optimizes the whole DAG (shared
subexpressions, transposes folded into the GEMM, elementwise runs fused into
one per-block function) before it runs the nodes on the eager block-native
primitives.

Two ways in::

    with repro_torch.lazy():          # every DsArray op records
        y = ((a + b) * 2.0).abs().sum(axis=0)
    y = y.compute()

    y = a.lazy() + b                  # or lift one array
    y.compute()

Each node ``lower``s itself onto the eager primitives.  Its output metadata
(grid, dtype, pad state) is inferred when the node is recorded by running
that same ``lower`` on arrays whose blocks are ``meta`` tensors: shapes and
dtypes without data, so recording reads no data, launches no kernel and
moves no launch counter, and the eager layer's pad-state propagation
carries over to whole plans.  Inference is memoised by structure.

==============  ==========================================================
node            records
==============  ==========================================================
``Leaf``        a concrete DsArray (plan input)
``ArrayLeaf``   a raw tensor input (index vectors, shuffle permutations)
``Blockwise``   elementwise / map_blocks over aligned operands (fusible)
``Transpose``   block transpose + grid swap
``PadGrid``     stacked-grid growth (operand alignment)
``AsType``      dtype cast
``MatMul``      blocked GEMM, optionally with the A-transpose folded in
``Reduce``      sum/max/min over an axis (or all)
``GetItem``     slice / integer-array selection
``Rechunk``     re-blocking
``ConcatRows``  vertical concat
``Shuffle``     pseudo / exact row shuffle
``Densify``     sparse -> dense
``ToSparse``    dense -> sparse at a static ``nse``
``Canonicalize`` sparse duplicates merged, capacity cut to a static ``nse``
==============  ==========================================================

Sparse operands (``core.sparse``) record the eager dispatch's
classification: a sparse ``Blockwise`` carries a stacked-COO fn (a data
map, an index merge or a gather), is a fusion boundary in ``core.plan``
and still CSEs and caches; an op with no zero-preserving sparse form
records an explicit ``Densify`` first.  Every node's ``nse`` is static:
sp ± sp adds its operands' capacities, sp * sp takes the smaller, and
``Canonicalize``/``ToSparse`` take their explicit ``nse``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core import sparse as sparse_mod
from repro_torch.core.blocking import BlockGrid
from repro_torch.core.dsarray import (PAD_DIRTY, PAD_ZERO, DsArray, PadState,
                                      _scalar_operand, matmul_ta, pad_state_of)

# ---------------------------------------------------------------------------
# The lazy-mode switch.  ``lazy()`` arms recording: the DsArray entry points
# check ``lazy_active()`` and return recordings.  ``suspend_lazy()`` masks it
# while metadata inference and plan execution run those same eager methods.
# ---------------------------------------------------------------------------

_STATE = threading.local()


def _depth(name: str) -> int:
    return getattr(_STATE, name, 0)


def lazy_active() -> bool:
    return _depth("lazy") > 0 and _depth("suspend") == 0


@contextlib.contextmanager
def lazy():
    """Context manager arming lazy recording for DsArray ops (re-entrant)."""
    _STATE.lazy = _depth("lazy") + 1
    try:
        yield
    finally:
        _STATE.lazy = _depth("lazy") - 1


@contextlib.contextmanager
def suspend_lazy():
    """Mask ``lazy_active()`` while eager primitives run inside the layer."""
    _STATE.suspend = _depth("suspend") + 1
    try:
        yield
    finally:
        _STATE.suspend = _depth("suspend") - 1


# ---------------------------------------------------------------------------
# Expression nodes
# ---------------------------------------------------------------------------


def _is_ds(meta) -> bool:
    return isinstance(meta, DsArray)


def _is_sparse(meta) -> bool:
    """True for a ds-shaped meta whose blocks are a stacked COO: the
    ``block_format`` the lazy layer carries along every node."""
    return _is_ds(meta) and meta.is_sparse


def _abstract(t):
    """A ``meta`` twin of a tensor or stacked COO: shapes, dtypes and
    flags, no data."""
    if isinstance(t, sparse_mod.StackedCOO):
        return sparse_mod.StackedCOO(_abstract(t.data), _abstract(t.indices),
                                     t.shape, t.indices_sorted,
                                     t.unique_indices)
    return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")


def _meta_sig(meta) -> tuple:
    """Hashable signature of a node's output metadata.  Sparse metas add
    the format, ``nse`` and flags: arrays that differ only in stored-entry
    capacity must not share memoised metadata."""
    if _is_ds(meta):
        fmt = ("dense",)
        if _is_sparse(meta):
            b = meta.blocks
            fmt = ("bcoo", b.nse, b.indices_sorted, b.unique_indices)
        return ("ds", tuple(meta.blocks.shape), str(meta.blocks.dtype),
                meta.grid, meta.pad_state) + fmt
    return ("arr", tuple(meta.shape), str(meta.dtype))


# A node's meta is a pure function of (class, static params, child metas),
# so inference runs once per distinct structure: re-recording a hot-loop
# body and the optimizer's rebuilds hit the memo.  Bounded by clearing.
_META_MEMO: dict = {}
_META_MEMO_MAX = 4096


class Expr:
    """A node of the recorded DAG.

    ``children`` are input Exprs; ``meta`` is the output described as a
    DsArray whose ``blocks`` is a ``meta`` tensor (so grid and pad state
    ride along), or a bare ``meta`` tensor for a scalar result.
    ``lower(*vals)`` maps child values to the output value using only the
    eager block-native primitives: it is the single source of truth for
    metadata inference (on ``meta`` tensors) and plan execution.
    """

    __slots__ = ("children", "meta")

    def lower(self, *vals):
        raise NotImplementedError

    def local_key(self):
        """Hashable structural identity of this node, children excluded."""
        raise NotImplementedError

    def _meta_key_extra(self) -> tuple:
        """Memo-key state that changes ``lower`` but is not always part of
        ``local_key`` (a Blockwise's resolved pad)."""
        return ()

    def _infer_meta(self) -> None:
        try:
            key = (type(self), self.local_key(), self._meta_key_extra(),
                   tuple(_meta_sig(c.meta) for c in self.children))
            hit = _META_MEMO.get(key)
        except TypeError:           # unhashable param: infer uncached
            key = hit = None
        if hit is not None:
            self.meta = hit
            return
        with suspend_lazy():
            self.meta = self.lower(*[c.meta for c in self.children])
        if key is not None:
            if len(_META_MEMO) >= _META_MEMO_MAX:
                _META_MEMO.clear()
            _META_MEMO[key] = self.meta

    def rebuild(self, children: Sequence["Expr"]) -> "Expr":
        """This node over new children (the optimizer's rewrites)."""
        raise NotImplementedError


class Leaf(Expr):
    """A concrete DsArray: a plan input, keyed by its signature and never by
    its data, so plans over other arrays of the same signature share one
    cached run."""

    __slots__ = ("value",)

    def __init__(self, value: DsArray):
        self.value = value
        self.children = ()
        self.meta = DsArray(_abstract(value.blocks), value.grid,
                            value.pad_state)

    def signature(self):
        g = self.value.grid
        fmt = ("bcoo", self.value.blocks.nse) if self.value.is_sparse \
            else ("dense",)
        return ("leaf", g.shape, g.block_shape, self.value.stacked_grid,
                str(self.value.dtype), self.value.pad_state) + fmt

    def local_key(self):
        return self.signature()

    def rebuild(self, children):
        return self


class ArrayLeaf(Expr):
    """A raw tensor plan input (index vectors, shuffle permutations): its
    values are run-time data, so a plan recorded again with a new index of
    the same shape hits the plan cache."""

    __slots__ = ("value",)

    def __init__(self, value: torch.Tensor):
        self.value = value
        self.children = ()
        self.meta = _abstract(value)

    def signature(self):
        return ("aleaf", tuple(self.value.shape), str(self.value.dtype))

    def local_key(self):
        return self.signature()

    def rebuild(self, children):
        return self


class Blockwise(Expr):
    """Elementwise / map_blocks op over grid-aligned operands.

    ``fn(*blocks)`` takes the children's stacked block tensors (and any 0-d
    scalar-expression values) and returns one stacked tensor of the same
    shape.  The optimizer fuses chains of these into one composed per-block
    function; the output pad state comes from probing the function on the
    children's pad constants, so a chain pays at most one remask, at its
    consumer.  With no ds-array child the node is a scalar computation and
    ``lower`` returns the raw tensor.

    ``elementwise`` marks functions known to be position-independent
    (everything the facade records itself); a user ``map_blocks`` fn is
    not, which blocks the optimizer's transpose hoist for it.
    """

    __slots__ = ("fn", "key", "pad", "elementwise")

    def __init__(self, fn: Callable, children: Sequence[Expr], key,
                 pad: Optional[PadState] = None, elementwise: bool = False):
        self.fn = fn
        self.key = key
        self.elementwise = elementwise
        self.children = tuple(children)
        self.pad = self._probe_pad() if pad is None else pad
        self._infer_meta()

    def _probe_pad(self) -> PadState:
        """``fn`` on (1, 1, 1, 1) CPU tensors holding the children's pad
        constants, as the eager ``_probe_binary_pad`` / ``_probe_map_pad``
        do; a 0-d expression operand (value unknown when recorded) or any
        failure gives DIRTY.  A node over a sparse operand is ZERO: the
        facade records only zero-preserving sparse fns, and sparse results
        are zero-padded by construction."""
        metas = [c.meta for c in self.children]
        if any(_is_sparse(m) for m in metas):
            return PAD_ZERO
        if not all(_is_ds(m) for m in metas):
            return PAD_DIRTY
        if any(m.pad_state.kind == "dirty" for m in metas):
            return PAD_DIRTY
        try:
            probes = [torch.full((1, 1, 1, 1),
                                 np.asarray(m.pad_state.value).item(),
                                 dtype=m.dtype) for m in metas]
            out = self.fn(*probes)
        except (TypeError, ValueError, RuntimeError, ZeroDivisionError):
            return PAD_DIRTY
        if not isinstance(out, torch.Tensor) or tuple(out.shape) != (1, 1, 1, 1):
            return PAD_DIRTY
        return pad_state_of(out)

    def lower(self, *vals):
        out = self.fn(*[v.blocks if isinstance(v, DsArray) else v
                        for v in vals])
        ref = next((v for v in vals if isinstance(v, DsArray)), None)
        if ref is None:
            return out
        # a sparse result is zero-padded by construction, whatever the
        # resolved claim (made for the dense fns) says
        pad = PAD_ZERO if isinstance(out, sparse_mod.StackedCOO) else self.pad
        return DsArray(out, ref.grid, pad)

    def local_key(self):
        return ("bw", self.key)

    def _meta_key_extra(self):
        return (self.pad,)

    def rebuild(self, children):
        # keep the RESOLVED pad: an explicit one (PAD_DIRTY on a
        # position-dependent map_blocks) cannot be re-derived by the probe
        return Blockwise(self.fn, children, self.key, pad=self.pad,
                         elementwise=self.elementwise)


class Transpose(Expr):
    __slots__ = ()

    def __init__(self, child: Expr):
        self.children = (child,)
        self._infer_meta()

    def lower(self, v):
        return v.transpose()

    def local_key(self):
        return ("T",)

    def rebuild(self, children):
        return Transpose(children[0])


class PadGrid(Expr):
    """Grow the stacked grid (operand alignment before a Blockwise)."""

    __slots__ = ("target",)

    def __init__(self, child: Expr, target: Tuple[int, int]):
        self.target = tuple(target)
        self.children = (child,)
        self._infer_meta()

    def lower(self, v):
        return v._pad_grid_to(self.target)

    def local_key(self):
        return ("padgrid", self.target)

    def rebuild(self, children):
        return PadGrid(children[0], self.target)


class AsType(Expr):
    __slots__ = ("dtype",)

    def __init__(self, child: Expr, dtype: torch.dtype):
        self.dtype = dtype
        self.children = (child,)
        self._infer_meta()

    def lower(self, v):
        return v.astype(self.dtype)

    def local_key(self):
        return ("astype", str(self.dtype))

    def rebuild(self, children):
        return AsType(children[0], self.dtype)


class Densify(Expr):
    """Block-format conversion sparse -> dense, recorded in front of ops
    with no zero-preserving sparse form (``+ scalar``, ``exp``, dense / sp,
    ...): an explicit plan node, so a sparse chain never densifies silently
    inside a fused body."""

    __slots__ = ()

    def __init__(self, child: Expr):
        self.children = (child,)
        self._infer_meta()

    def lower(self, v):
        return v.todense()

    def local_key(self):
        return ("densify",)

    def rebuild(self, children):
        return Densify(children[0])


class ToSparse(Expr):
    """Block-format conversion dense -> sparse at a STATIC ``nse`` (entry
    capacity per block): nnz is run-time data the recorder cannot see, so
    the caller chooses the capacity (``costmodel.tosparse_pays`` says when
    the conversion pays at all)."""

    __slots__ = ("nse",)

    def __init__(self, child: Expr, nse: int):
        self.nse = int(nse)
        self.children = (child,)
        self._infer_meta()

    def lower(self, v):
        return v.tosparse(nse=self.nse)

    def local_key(self):
        return ("tosparse", self.nse)

    def rebuild(self, children):
        return ToSparse(children[0], self.nse)


class Canonicalize(Expr):
    """Capacity re-compaction inside a plan: duplicate indices merged and
    the capacity cut to a STATIC ``nse``.

    Recorded sp ± sp nodes concatenate entry lists, so a chain's capacity
    grows as the sum of its operands' ``nse``.  A block holds at most
    ``bn*bm`` distinct positions, so compacting to that bound keeps every
    value and a static shape.  The facade inserts this node when
    ``costmodel.bcoo_recompaction_pays`` says the capacity passed the
    bound; like every sparse node it is a fusion boundary but CSEs and
    caches by structure and ``nse``."""

    __slots__ = ("nse",)

    def __init__(self, child: Expr, nse: int):
        self.nse = int(nse)
        self.children = (child,)
        self._infer_meta()

    def lower(self, v):
        return sparse_mod.canonicalize(v, nse=self.nse)

    def local_key(self):
        return ("canon", self.nse)

    def rebuild(self, children):
        return Canonicalize(children[0], self.nse)


def _maybe_compact(node: Expr) -> Expr:
    """``node`` wrapped in :class:`Canonicalize` when its sparse capacity
    passed the per-block position bound (pigeonhole: the excess slots are
    duplicates every consumer pays for)."""
    if not _is_sparse(node.meta):
        return node
    bn, bm = node.meta.block_shape
    if costmodel.bcoo_recompaction_pays(node.meta.blocks.nse, bn * bm):
        return Canonicalize(node, bn * bm)
    return node


class MatMul(Expr):
    """Blocked GEMM.  ``transpose_a=True`` is the optimizer's folded form of
    ``MatMul(Transpose(x), y)``: it lowers through ``matmul_ta``, which
    launches the GEMM with ``transpose_a`` so that the kernel reads ``x``
    transposed through its strides; ``xᵀ`` is never materialised."""

    __slots__ = ("transpose_a",)

    def __init__(self, a: Expr, b: Expr, transpose_a: bool = False):
        self.transpose_a = transpose_a
        self.children = (a, b)
        self._infer_meta()

    def lower(self, a, b):
        if self.transpose_a:
            return matmul_ta(a, b)
        return a @ b

    def local_key(self):
        return ("mm", self.transpose_a)

    def rebuild(self, children):
        return MatMul(children[0], children[1], self.transpose_a)


class Reduce(Expr):
    __slots__ = ("op", "axis")

    def __init__(self, child: Expr, op: str, axis: Optional[int]):
        self.op = op
        self.axis = axis
        self.children = (child,)
        self._infer_meta()

    def lower(self, v):
        return v._reduce(self.op, self.axis)

    def local_key(self):
        return ("reduce", self.op, self.axis)

    def rebuild(self, children):
        return Reduce(children[0], self.op, self.axis)


def _device_of(e: Expr) -> torch.device:
    """The device of the first concrete input under ``e``."""
    if isinstance(e, (Leaf, ArrayLeaf)):
        return e.value.device
    return _device_of(e.children[0])


def _norm_index(k, size: int, device, what: str):
    """Record-time form of one axis of a getitem key: ``("static", hashable
    descriptor, value)`` for ints and slices, ``("array", ArrayLeaf, None)``
    for an index array, which is wrapped, range-checked here on the real
    index and placed on the array's device (the plan then checks nothing)."""
    from repro_torch.core import structural
    if isinstance(k, (int, np.integer)):
        return ("static", ("i", int(k)), int(k))
    if isinstance(k, slice):
        return ("static", ("s", k.start, k.stop, k.step), k)
    idx = structural.index_vector(structural.as_index(k), size, device, what)
    return ("array", ArrayLeaf(idx), None)


class GetItem(Expr):
    """Slice / filter.  Ints and slices are plan structure; index arrays are
    ``ArrayLeaf`` children."""

    __slots__ = ("rows_desc", "cols_desc")

    def __init__(self, child: Expr, rows, cols):
        self.rows_desc = rows
        self.cols_desc = cols
        self.children = (child,) + tuple(d[1] for d in (rows, cols)
                                         if d[0] == "array")
        self._infer_meta()

    def lower(self, v, *idx_arrays):
        from repro_torch.core import structural
        arrays = list(idx_arrays)
        rows, cols = (d[2] if d[0] == "static" else arrays.pop(0)
                      for d in (self.rows_desc, self.cols_desc))
        return structural.getitem(v, (rows, cols), checked=True)

    def local_key(self):
        def part(desc):
            return desc[1] if desc[0] == "static" else ("a",)
        return ("getitem", part(self.rows_desc), part(self.cols_desc))

    def rebuild(self, children):
        kids = list(children)
        child = kids.pop(0)
        rows, cols = (("array", kids.pop(0), None) if d[0] == "array" else d
                      for d in (self.rows_desc, self.cols_desc))
        return GetItem(child, rows, cols)


class Rechunk(Expr):
    __slots__ = ("block_shape",)

    def __init__(self, child: Expr, block_shape: Tuple[int, int]):
        self.block_shape = (int(block_shape[0]), int(block_shape[1]))
        self.children = (child,)
        self._infer_meta()

    def lower(self, v):
        from repro_torch.core import structural
        return structural.rechunk(v, self.block_shape)

    def local_key(self):
        return ("rechunk", self.block_shape)

    def rebuild(self, children):
        return Rechunk(children[0], self.block_shape)


class ConcatRows(Expr):
    __slots__ = ()

    def __init__(self, parts: Sequence[Expr]):
        self.children = tuple(parts)
        self._infer_meta()

    def lower(self, *vals):
        from repro_torch.core import structural
        return structural.concat_rows(list(vals))

    def local_key(self):
        return ("concat", len(self.children))

    def rebuild(self, children):
        return ConcatRows(children)


class Shuffle(Expr):
    """Row shuffle; the source rows, drawn when the op was recorded, are an
    ``ArrayLeaf`` input, so the plan is a pure function of its inputs."""

    __slots__ = ("kind",)

    def __init__(self, child: Expr, rows: ArrayLeaf, kind: str):
        if kind not in ("pseudo", "exact"):
            raise ValueError(f"unknown shuffle {kind!r}")
        self.kind = kind
        self.children = (child, rows)
        self._infer_meta()

    def lower(self, v, rows):
        from repro_torch.core import shuffle
        return shuffle.apply_rows(v, self.kind, rows)

    def local_key(self):
        return ("shuffle", self.kind)

    def rebuild(self, children):
        return Shuffle(children[0], children[1], self.kind)


# ---------------------------------------------------------------------------
# Recording helpers
# ---------------------------------------------------------------------------


def lift(x) -> Expr:
    """``x`` as an Expr: a lazy value's expr, a DsArray as a Leaf."""
    if isinstance(x, (LazyDsArray, LazyScalar)):
        return x.expr
    if isinstance(x, DsArray):
        return Leaf(x)
    raise TypeError(f"cannot lift {type(x).__name__} into the lazy IR")


def lift_lazy(x: DsArray) -> "LazyDsArray":
    return LazyDsArray(Leaf(x))


def _scalar_key(v) -> tuple:
    """Hashable identity of a baked scalar operand WITH its type: tuple keys
    hash ``1``, ``1.0`` and ``True`` alike, and an int plan must not answer
    a float recording."""
    if isinstance(v, torch.Tensor):
        return (v.item(), str(v.dtype))
    return (v, type(v).__name__)


def _align(a: Expr, b: Expr) -> Tuple[Expr, Expr]:
    """Rechunk/PadGrid so both operands have one stacked shape (the
    recorded mirror of the eager ``_binary``'s alignment)."""
    am, bm = a.meta, b.meta
    if am.shape != bm.shape:
        raise ValueError(f"shape mismatch {am.shape} vs {bm.shape}")
    if am.block_shape != bm.block_shape:
        b = Rechunk(b, am.block_shape)
        bm = b.meta
    if am.stacked_grid != bm.stacked_grid:
        common = (max(am.stacked_grid[0], bm.stacked_grid[0]),
                  max(am.stacked_grid[1], bm.stacked_grid[1]))
        if am.stacked_grid != common:
            a = PadGrid(a, common)
        if bm.stacked_grid != common:
            b = PadGrid(b, common)
    return a, b


def _wrap(e: Expr):
    """LazyDsArray for a ds-shaped result, LazyScalar otherwise."""
    return LazyDsArray(e) if _is_ds(e.meta) else LazyScalar(e)


def _ordered(op: Callable, reverse: bool) -> Callable:
    return (lambda x, y: op(y, x)) if reverse else (lambda x, y: op(x, y))


class LazyScalar:
    """A 0-d expression (a whole-array reduction) with the small algebra the
    ds-array API needs (scale, sqrt) and ``compute()``."""

    __slots__ = ("expr",)

    def __init__(self, expr: Expr):
        self.expr = expr

    @property
    def dtype(self) -> torch.dtype:
        return self.expr.meta.dtype

    def _map(self, fn: Callable, key) -> "LazyScalar":
        return LazyScalar(Blockwise(fn, (self.expr,), key, elementwise=True))

    def _binary(self, other, op: Callable, reverse: bool, name: str):
        if isinstance(other, (LazyDsArray, LazyScalar, DsArray)):
            oe = lift(other)
            if _is_sparse(oe.meta):
                oe = Densify(oe)    # a scalar of unknown value: densify
            return _wrap(Blockwise(_ordered(op, reverse), (self.expr, oe),
                                   (name, reverse), elementwise=True))
        s = _scalar_operand(other)
        if s is None:
            return NotImplemented
        if isinstance(s, torch.Tensor):
            s = s.detach().cpu()
        sk = _scalar_key(s)
        if reverse:
            return self._map(lambda x: op(s, x), (name, True, sk))
        return self._map(lambda x: op(x, s), (name, False, sk))

    def __add__(self, o):
        return self._binary(o, torch.add, False, "add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, torch.sub, False, "sub")

    def __rsub__(self, o):
        return self._binary(o, torch.sub, True, "sub")

    def __mul__(self, o):
        return self._binary(o, torch.mul, False, "mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, torch.true_divide, False, "div")

    def __rtruediv__(self, o):
        return self._binary(o, torch.true_divide, True, "div")

    def sqrt(self) -> "LazyScalar":
        return self._map(torch.sqrt, ("sqrt",))

    def compute(self) -> torch.Tensor:
        from repro_torch.core import plan
        return plan.compute(self.expr)

    def __float__(self) -> float:
        return float(self.compute())


class LazyDsArray:
    """Recorded ds-array: mirrors the ``DsArray`` API, but every op appends
    an ``Expr`` node instead of running.  ``compute()`` optimizes and runs
    the whole recorded plan (``core.plan``)."""

    __slots__ = ("expr",)

    def __init__(self, expr: Expr):
        if not _is_ds(expr.meta):
            raise TypeError("expression does not produce a ds-array")
        self.expr = expr

    # -- metadata (inferred on meta tensors when recorded) -------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return self.expr.meta.shape

    @property
    def block_shape(self) -> Tuple[int, int]:
        return self.expr.meta.block_shape

    @property
    def grid(self) -> BlockGrid:
        return self.expr.meta.grid

    @property
    def stacked_grid(self) -> Tuple[int, int]:
        return self.expr.meta.stacked_grid

    @property
    def dtype(self) -> torch.dtype:
        return self.expr.meta.dtype

    @property
    def pad_state(self) -> PadState:
        return self.expr.meta.pad_state

    @property
    def block_format(self) -> str:
        return "bcoo" if _is_sparse(self.expr.meta) else "dense"

    @property
    def is_sparse(self) -> bool:
        return self.block_format == "bcoo"

    @property
    def ndim(self) -> int:
        return 2

    @property
    def T(self) -> "LazyDsArray":
        return self.transpose()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"LazyDsArray(shape={self.shape}, "
                f"block_shape={self.block_shape}, dtype={self.dtype})")

    # -- materialization -----------------------------------------------------
    def compute(self) -> DsArray:
        from repro_torch.core import plan
        return plan.compute(self.expr)

    def collect(self) -> torch.Tensor:
        return self.compute().collect()

    def lazy(self) -> "LazyDsArray":
        return self

    # -- block-format conversions --------------------------------------------
    def todense(self) -> "LazyDsArray":
        if not self.is_sparse:
            return self
        return LazyDsArray(Densify(self.expr))

    def tosparse(self, nse: Optional[int] = None) -> "LazyDsArray":
        if self.is_sparse:
            return self
        if nse is None:
            raise ValueError(
                "lazy tosparse needs an explicit nse= (stored entries per "
                "block): nnz is run-time data the recorder cannot see; "
                "convert eagerly or pass a capacity")
        return LazyDsArray(ToSparse(self.expr, nse))

    # -- elementwise ---------------------------------------------------------
    def _binary(self, other, op: Callable, reverse: bool = False,
                name: Optional[str] = None):
        name = name or getattr(op, "__name__", "op")
        if isinstance(other, (LazyDsArray, DsArray)):
            a, b = _align(self.expr, lift(other))
            fa, fb = _is_sparse(a.meta), _is_sparse(b.meta)
            if fa or fb:
                # the eager dispatch's classification; sparse Blockwise
                # nodes carry stacked-COO fns and are fusion boundaries
                mode = sparse_mod.classify_binary(
                    op, fa, ("ds", fb, b.meta.dtype), reverse, a.meta.dtype)
                if mode == "pair":
                    # sp ± sp concatenates entry lists: compact the capacity
                    # back to the block bound once growth stops paying
                    return LazyDsArray(_maybe_compact(Blockwise(
                        sparse_mod.pair_fn(op, reverse), (a, b),
                        ("sp-pair", name, reverse), pad=PAD_ZERO,
                        elementwise=True)))
                if mode == "gather":
                    return LazyDsArray(Blockwise(
                        sparse_mod.gather_fn(_ordered(op, reverse), fa), (a, b),
                        ("sp-gather", name, reverse), pad=PAD_ZERO,
                        elementwise=True))
                a = Densify(a) if fa else a
                b = Densify(b) if fb else b
            return LazyDsArray(Blockwise(_ordered(op, reverse), (a, b),
                                         (name, reverse), elementwise=True))
        if isinstance(other, LazyScalar):
            # the scalar's value is unknown when recorded, so nothing proves
            # the op zero-preserving: a sparse operand densifies
            return LazyDsArray(Blockwise(_ordered(op, reverse),
                                         (self.todense().expr, other.expr),
                                         (name, reverse), elementwise=True))
        s = _scalar_operand(other)
        if s is None:
            return NotImplemented
        me = self
        if me.dtype == torch.bool and type(s) in (int, float):
            # as the eager _binary: a Python scalar lifts bool to 32 bits
            me = me.astype(torch.int32 if type(s) is int else torch.float32)
        if isinstance(s, torch.Tensor):
            s = s.detach().cpu()    # baked once: no host sync in the plan
        if me.is_sparse:
            if sparse_mod.classify_binary(op, True, s, reverse,
                                          me.dtype) == "data":
                return LazyDsArray(Blockwise(
                    sparse_mod.data_map_fn(op, s, reverse), (me.expr,),
                    ("sp-data", name, reverse, _scalar_key(s)), pad=PAD_ZERO,
                    elementwise=True))
            me = me.todense()
        fn = (lambda x: op(s, x)) if reverse else (lambda x: op(x, s))
        return LazyDsArray(Blockwise(fn, (me.expr,),
                                     (name, reverse, _scalar_key(s)),
                                     elementwise=True))

    def __add__(self, o):
        return self._binary(o, torch.add)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, torch.sub)

    def __rsub__(self, o):
        return self._binary(o, torch.sub, reverse=True)

    def __mul__(self, o):
        return self._binary(o, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, torch.true_divide)

    def __rtruediv__(self, o):
        return self._binary(o, torch.true_divide, reverse=True)

    def __pow__(self, o):
        return self._binary(o, torch.pow)

    def __rpow__(self, o):
        return self._binary(o, torch.pow, reverse=True)

    def __neg__(self):
        return self.map_blocks(torch.neg, _key=("neg",), _elementwise=True)

    def map_blocks(self, fn: Callable, pad: Optional[PadState] = None,
                   _key=None, _elementwise: bool = False) -> "LazyDsArray":
        # the fn OBJECT is part of the key (functions hash by identity, and
        # the plan key holding it keeps the id stable); a user fn is not
        # marked elementwise: it may depend on position
        key = _key if _key is not None else ("map", fn, pad)
        if self.is_sparse:
            if pad is None and sparse_mod.zero_preserving_map(fn, self.dtype):
                return LazyDsArray(Blockwise(
                    sparse_mod.sparse_map_fn(fn), (self.expr,), ("sp",) + key,
                    pad=PAD_ZERO, elementwise=_elementwise))
            return self.todense().map_blocks(fn, pad=pad, _key=_key,
                                             _elementwise=_elementwise)
        return LazyDsArray(Blockwise(fn, (self.expr,), key, pad=pad,
                                     elementwise=_elementwise))

    def sqrt(self) -> "LazyDsArray":
        return self.map_blocks(torch.sqrt, _key=("sqrt",), _elementwise=True)

    def exp(self) -> "LazyDsArray":
        return self.map_blocks(torch.exp, _key=("exp",), _elementwise=True)

    def abs(self) -> "LazyDsArray":
        return self.map_blocks(torch.abs, _key=("abs",), _elementwise=True)

    def astype(self, dtype: torch.dtype) -> "LazyDsArray":
        return LazyDsArray(AsType(self.expr, dtype))

    # -- structural ----------------------------------------------------------
    def transpose(self) -> "LazyDsArray":
        return LazyDsArray(Transpose(self.expr))

    def rechunk(self, block_shape: Tuple[int, int]) -> "LazyDsArray":
        bs = (int(block_shape[0]), int(block_shape[1]))
        if bs == self.block_shape:
            return self
        return LazyDsArray(Rechunk(self.expr, bs))

    def __getitem__(self, key) -> "LazyDsArray":
        if not isinstance(key, tuple):
            key = (key, slice(None))
        if len(key) != 2:
            raise IndexError("ds-arrays are 2-D")
        dev = _device_of(self.expr)
        return LazyDsArray(GetItem(
            self.expr, _norm_index(key[0], self.shape[0], dev, "row"),
            _norm_index(key[1], self.shape[1], dev, "col")))

    def __matmul__(self, other):
        if not isinstance(other, (LazyDsArray, DsArray)):
            return NotImplemented
        return LazyDsArray(MatMul(self.expr, lift(other)))

    def __rmatmul__(self, other):
        if not isinstance(other, DsArray):
            return NotImplemented
        return LazyDsArray(MatMul(lift(other), self.expr))

    # -- reductions ----------------------------------------------------------
    def _reduce(self, op: str, axis: Optional[int]):
        return _wrap(Reduce(self.expr, op, axis))

    def sum(self, axis: Optional[int] = None):
        return self._reduce("sum", axis)

    def max(self, axis: Optional[int] = None):
        return self._reduce("max", axis)

    def min(self, axis: Optional[int] = None):
        return self._reduce("min", axis)

    def mean(self, axis: Optional[int] = None):
        n, m = self.shape
        denom = {None: n * m, 0: n, 1: m}[axis]
        me = self
        if not self.dtype.is_floating_point:
            me = self.astype(torch.promote_types(self.dtype, torch.float32))
        return me.sum(axis) / float(denom)

    def norm(self, axis: Optional[int] = None):
        return self._binary(self, torch.mul).sum(axis).sqrt()


def record_shuffle(generator: torch.Generator, a, kind: str) -> LazyDsArray:
    """Record a shuffle: its source rows are drawn now, from ``generator``,
    exactly as the eager shuffle draws them, and enter the plan as an
    input."""
    from repro_torch.core import shuffle
    e = lift(a)
    m = e.meta
    kind, src = shuffle.source_rows(generator, kind, m.shape, m.block_shape,
                                    m.stacked_grid[0], _device_of(e))
    return LazyDsArray(Shuffle(e, ArrayLeaf(src), kind))


def record_concat(arrays: Sequence) -> LazyDsArray:
    return LazyDsArray(ConcatRows(tuple(lift(a) for a in arrays)))
