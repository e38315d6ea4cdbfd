"""DsArray: the paper's distributed array over one PyTorch tensor.

The port of ``repro.core.dsarray``.  A ds-array is a 2-D array cut into
blocks of arbitrary size; here the blocks live in one **stacked block
tensor** of shape ``(gn, gm, bn, bm)`` (grid dims first, block dims last).
Edge blocks are padded, and each array carries a **pad state**: ``ZERO``
(pad exactly 0), ``FILL(v)`` (pad is the known constant v) or ``DIRTY``
(unknown), derived by running each op on the pad constants.  Consumers that
need a zero pad (reductions, matmul, structural ops) call
``ensure_zero_pad()``, so zero-preserving op chains pay no mask pass at all.

Block formats (paper §4.2: blocks are NumPy arrays OR scipy.sparse CSR):
``block_format`` is ``"dense"`` for the stacked tensor above and ``"bcoo"``
for a ``core.sparse.StackedCOO`` over the same grid, which is ZERO-padded
by construction.  On a sparse array, scalar scale/neg/abs/sqrt, sp ± sp,
sp * sp, sp * dense, sp / dense, ``astype``, ``transpose``, ``sum``,
``sp @ dense``, ``matmul_ta(sp, dense)`` and the block-aligned slice stay
sparse; ``+ scalar``, ``exp``, dense / sp, max/min, the other structural
ops and ``apply_along_axis`` densify, and a sparse right operand of ``@``
densifies (the table in ``repro.core.dsarray``, op for op).

Device rule: every creation routine takes ``device=`` (default ``"cuda"``);
every other op runs where its input tensors are.  Nothing picks the device
from the environment, and a CUDA request on a machine without a card
raises instead of landing on the CPU.

Dtypes stay 32-bit, as in the JAX package (which never enables x64):
``from_array`` turns float64 into float32 and int64 into int32.

Distribution (``distribute``): the stacked blocks become a ``DTensor`` on
a ``DeviceMesh``, grid dims sharded over two named mesh axes
(``core.placement``).  Every rank runs the same program (SPMD), so on a
distributed array ``collect()`` and the reductions are collective calls.
The elementwise ops, ``map_blocks``, ``astype``, ``ensure_zero_pad`` and
the reductions work on each rank's shard (a reduction all-reduces its
partials; ``sum(axis=0)`` comes back replicated on the mesh axis of grid
dim 0, as ``core.shmap_ops.colsum_psum``'s); ``transpose`` permutes each
shard, and its result has the mirrored placement (the mesh axis of grid
dim 0 then shards grid dim 1).  ``@`` runs ``shmap_ops.summa_matmul``
and ``matmul_ta`` ``shmap_ops.matmul_ta_psum``.  The structural ops,
``apply_along_axis`` and every op on
sparse blocks but ``todense``/``collect`` run on the gathered blocks and
place the result on the operand's mesh and axes (``core.shmap_ops`` lists
them).  No DTensor reaches a kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import placement as _pl
from repro_torch.core.blocking import BlockGrid, round_up
from repro_torch.kernels import _record

Number = Union[int, float]

# what 64-bit inputs become, so dtypes match the 32-bit reference
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _lazy_mode() -> bool:
    """True when ``repro_torch.lazy()`` recording is armed (``core.expr``).

    Checked at the top of every recordable op; resolved through
    ``sys.modules`` so that arrays never pay an import before the lazy layer
    is loaded (it cannot be armed before then).
    """
    expr = sys.modules.get("repro_torch.core.expr")
    return expr is not None and expr.lazy_active()


def _recordable(method):
    """A DsArray op that, with recording armed, records the same op on the
    array's lazy twin (``LazyDsArray`` has a method of the same name)."""
    @functools.wraps(method)
    def op(self, *args, **kwargs):
        if _lazy_mode():
            from repro_torch.core import expr
            return getattr(expr.lift_lazy(self), method.__name__)(*args, **kwargs)
        return method(self, *args, **kwargs)
    return op


def _replace(out, like: "DsArray"):
    """``out`` placed on the mesh and axes of ``like`` when ``like`` is
    distributed (a result that is no ds-array is returned as it is)."""
    if isinstance(out, DsArray) and like.is_distributed:
        return out.distribute(*like.mesh_axes)
    return out


def _gathers(sparse_only: bool = False):
    """An op that, on a distributed array (with ``sparse_only``, a sparse
    one only), runs on the gathered blocks and places its result on the
    operand's mesh and axes."""
    def deco(method):
        @functools.wraps(method)
        def op(self, *args, **kwargs):
            if self.is_distributed and (self.is_sparse or not sparse_only):
                return _replace(method(self._gathered(), *args, **kwargs), self)
            return method(self, *args, **kwargs)
        return op
    return deco


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return dev


def _axis_mask(size: int, g: int, b: int, device, start: int = 0) -> torch.Tensor:
    """(g, b) bool mask of grid blocks ``start .. start + g``: True where
    the global index (block * b + offset) < size."""
    idx = torch.arange(start * b, (start + g) * b, device=device).reshape(g, b)
    return idx < size


def _valid_mask(grid: BlockGrid, stacked_grid: Tuple[int, int],
                device, start: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Boolean mask over the stacked tensor (or over the shard of it that
    starts at grid block ``start``) marking logically-valid elements, built
    from two per-axis masks broadcast together."""
    n, m = grid.shape
    bn, bm = grid.block_shape
    gn, gm = stacked_grid
    rows = _axis_mask(n, gn, bn, device, start[0])       # (gn, bn)
    cols = _axis_mask(m, gm, bm, device, start[1])       # (gm, bm)
    return rows[:, None, :, None] & cols[None, :, None, :]


# ---------------------------------------------------------------------------
# Pad-state tracking
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PadState:
    """Claim about the pad region: "zero" | "fill" (constant ``fill``) |
    "dirty" (unknown)."""

    kind: str
    fill: Optional[Any] = None

    @property
    def value(self):
        """The pad constant (only meaningful for zero/fill)."""
        return 0 if self.kind == "zero" else self.fill


PAD_ZERO = PadState("zero")
PAD_DIRTY = PadState("dirty")


def pad_state_of(val) -> PadState:
    """PadState for a known constant pad value; nan demotes to DIRTY."""
    try:
        if isinstance(val, torch.Tensor):
            item = val.item()
        else:
            item = np.asarray(val).item()
    except (TypeError, ValueError, RuntimeError):
        return PAD_DIRTY
    if item != item:  # nan
        return PAD_DIRTY
    if item == 0:
        return PAD_ZERO
    return PadState("fill", item)


def _probe_scalar(val, dtype) -> torch.Tensor:
    """A 0-d CPU tensor holding ``val`` in ``dtype`` for pad probing."""
    return torch.tensor(np.asarray(val).item(), dtype=dtype)


def _probe_binary_pad(op, lhs_state: PadState, lhs_dtype, rhs,
                      reverse: bool = False) -> PadState:
    """Pad state of ``op(lhs, rhs)`` from the operands' pad constants.

    ``rhs`` is a (PadState, dtype) pair for a DsArray operand, else a
    scalar.  Any failure of the probe demotes to DIRTY."""
    if lhs_state.kind == "dirty":
        return PAD_DIRTY
    try:
        lv = _probe_scalar(lhs_state.value, lhs_dtype)
        if isinstance(rhs, tuple):
            rstate, rdtype = rhs
            if rstate.kind == "dirty":
                return PAD_DIRTY
            rv = _probe_scalar(rstate.value, rdtype)
        elif isinstance(rhs, torch.Tensor):
            rv = rhs.detach().cpu()
        else:
            rv = rhs
        out = op(rv, lv) if reverse else op(lv, rv)
        return pad_state_of(out)
    except (TypeError, ValueError, RuntimeError, ZeroDivisionError):
        return PAD_DIRTY


def _probe_map_pad(fn, state: PadState, dtype) -> PadState:
    """Pad state of ``fn(blocks)`` for an elementwise ``fn``: run it on a
    (1,1,1,1) constant holding the pad value.  A failure or a change of
    shape demotes to DIRTY."""
    if state.kind == "dirty":
        return PAD_DIRTY
    try:
        probe = torch.full((1, 1, 1, 1), np.asarray(state.value).item(),
                           dtype=dtype)
        out = fn(probe)
        if getattr(out, "shape", None) != (1, 1, 1, 1):
            return PAD_DIRTY
        return pad_state_of(out)
    except (TypeError, ValueError, RuntimeError, ZeroDivisionError):
        return PAD_DIRTY


def _scalar_operand(other):
    """``other`` as a 0-d operand, or None when it is not a scalar."""
    if isinstance(other, (int, float)):
        return other
    if isinstance(other, (np.ndarray, np.generic)) and np.ndim(other) == 0:
        return np.asarray(other).item()
    if isinstance(other, torch.Tensor) and other.ndim == 0:
        return other
    return None


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t.to(dtype)``; a float to an integer type saturates as the
    reference's cast does on the CPU: NaN becomes 0, values past the
    type's range its bounds (``torch``'s own cast leaves them undefined)."""
    if not t.dtype.is_floating_point or dtype.is_floating_point \
            or dtype.is_complex or dtype == torch.bool:
        return t.to(dtype)
    # a graph recorder tags these passes: they are the cast's, not remasks
    return _record.scoped("cast", _saturating_cast, t, dtype)


def _saturating_cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    info = torch.iinfo(dtype)
    out = torch.where(torch.isnan(t), 0, t).to(dtype)
    out = torch.where(t >= float(info.max) + 1, info.max, out)
    return torch.where(t < info.min, info.min, out)


def _valid_reduce(red, combine, shape: Tuple[int, int], fill: Number):
    """``red(t, dims)`` over the valid elements of stacked blocks alone.

    The valid elements of an ``(n, m)`` array are the full blocks and the
    valid lines of the edge block-row and -column: four strided views,
    reduced apart and joined with ``combine``, so no masked copy of the
    operand is written (a grid with no pad is one view, the whole).  The
    result's pad lines hold ``fill``, as a reduce over remasked blocks
    gives them."""

    def valid(t, dims=None):
        if dims is None:
            return _combine(combine, [red(v) for v in _valid_views(t, shape)])
        if dims == (0, 2):               # axis 0: axis 1 of the transpose
            return _rows(red, combine, t.permute(1, 0, 3, 2), shape[::-1],
                         fill)
        return _rows(red, combine, t, shape, fill)

    return valid


def _valid_views(t: torch.Tensor, shape: Tuple[int, int]):
    """The (up to) four views of ``t``'s valid elements."""
    (i0, rv), (j0, cv) = divmod(shape[0], t.shape[2]), divmod(shape[1],
                                                              t.shape[3])
    views = []
    if i0 and j0:
        views.append(t[:i0, :j0])
    if i0 and cv:
        views.append(t[:i0, j0, :, :cv])
    if rv and j0:
        views.append(t[i0, :j0, :rv])
    if rv and cv:
        views.append(t[i0, j0, :rv, :cv])
    return views


def _rows(red, combine, t: torch.Tensor, shape: Tuple[int, int],
          fill: Number) -> torch.Tensor:
    """``red`` of each row of ``t``'s valid elements, as a ``(gn, bn)``
    tensor whose pad rows hold ``fill``."""
    gn, _, bn, bm = t.shape
    i0, rv = divmod(shape[0], bn)
    j0, cv = divmod(shape[1], bm)

    def across(r):                       # r: (k, gm, h, bm) -> (k, h)
        parts = []
        if j0:
            parts.append(red(r[:, :j0], (1, 3)))
        if cv:
            parts.append(red(r[:, j0, :, :cv], (2,)))
        return _combine(combine, parts)

    lines = []
    if i0:
        lines.append(across(t[:i0]).reshape(-1))
    if rv:
        lines.append(across(t[i0:i0 + 1, :, :rv]).reshape(-1))
    n_pad = gn * bn - i0 * bn - rv
    if n_pad:
        lines.append(torch.full((n_pad,), fill, dtype=lines[0].dtype,
                                device=t.device))
    out = lines[0] if len(lines) == 1 else torch.cat(lines)
    return out.reshape(gn, bn)


def _combine(combine, parts):
    out = parts[0]
    for p in parts[1:]:
        out = combine(out, p)
    return out


class DsArray:
    """2-D blocked array with a NumPy-like API (paper §4.2.3).

    Build one with :func:`from_array`, :func:`zeros`, :func:`full`,
    :func:`eye` or :func:`random_array`; sparse ones with
    ``core.sparse.from_scipy``, ``random_sparse`` or :meth:`tosparse`.
    """

    __slots__ = ("blocks", "grid", "pad_state")

    def __init__(self, blocks, grid: BlockGrid, pad_state: PadState = PAD_ZERO):
        if blocks.ndim != 4:
            raise ValueError(
                f"stacked block tensor must be rank 4, got {tuple(blocks.shape)}")
        bn, bm = grid.block_shape
        if tuple(blocks.shape[2:]) != (bn, bm):
            raise ValueError(
                f"block dims {tuple(blocks.shape[2:])} != block_shape "
                f"{grid.block_shape}")
        gn, gm = grid.grid
        if blocks.shape[0] < gn or blocks.shape[1] < gm:
            raise ValueError(
                f"stacked grid {tuple(blocks.shape[:2])} smaller than logical "
                f"grid {grid.grid}")
        if not isinstance(blocks, torch.Tensor) and pad_state.kind != "zero":
            # sparse blocks have NO entry in the pad region: the pad is
            # exactly zero by construction, any other claim is a bug
            raise ValueError(
                f"bcoo-blocked ds-arrays are zero-padded by construction, "
                f"got pad_state={pad_state}")
        self.blocks = blocks
        self.grid = grid
        self.pad_state = pad_state

    # -- basic properties -----------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return self.grid.shape

    @property
    def block_shape(self) -> Tuple[int, int]:
        return self.grid.block_shape

    @property
    def stacked_grid(self) -> Tuple[int, int]:
        return tuple(self.blocks.shape[:2])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        """The device of the blocks (of this rank's shard, when distributed)."""
        return _pl.local(self._leaf).device

    @property
    def _leaf(self) -> torch.Tensor:
        """The dense block tensor, or a sparse array's ``data``."""
        return self.blocks.data if self.is_sparse else self.blocks

    @property
    def is_distributed(self) -> bool:
        """True when the blocks are placed on a device mesh (:meth:`distribute`)."""
        return _pl.is_dtensor(self._leaf)

    @property
    def mesh_axes(self):
        """``(mesh, axes)`` of a distributed array: the ``DeviceMesh`` and
        the mesh axes of grid dims 0 and 1 (``None``: not sharded)."""
        if not self.is_distributed:
            raise ValueError("the array is not distributed")
        return _pl.axes_of(self._leaf)

    @property
    def block_format(self) -> str:
        """Storage of the stacked blocks: ``"dense"`` (a rank-4 tensor) or
        ``"bcoo"`` (a ``core.sparse.StackedCOO``), read off the blocks'
        type, so it can never disagree with the data it describes."""
        return "dense" if isinstance(self.blocks, torch.Tensor) else "bcoo"

    @property
    def is_sparse(self) -> bool:
        return self.block_format == "bcoo"

    @property
    def T(self) -> "DsArray":
        return self.transpose()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"DsArray(shape={self.shape}, block_shape={self.block_shape}, "
                f"grid={self.stacked_grid}, dtype={self.dtype}, "
                f"device={self.device})")

    # -- masking --------------------------------------------------------------
    def _mask(self) -> torch.Tensor:
        return _valid_mask(self.grid, self.stacked_grid, self.blocks.device)

    def _remask(self, fill: Number = 0) -> torch.Tensor:
        """Blocks with the pad region forced to ``fill``."""
        if self.is_sparse:
            raise RuntimeError("sparse blocks are zero-padded by construction"
                               " — there is nothing to remask")
        fill_v = torch.tensor(fill, dtype=self.dtype, device=self.device)
        if self.is_distributed:       # each rank masks its own shard
            loc = _pl.local(self.blocks)
            mask = _valid_mask(self.grid, tuple(loc.shape[:2]), loc.device,
                               _pl.offsets(self.blocks))
            return _pl.rewrap(torch.where(mask, loc, fill_v), self.blocks)
        return torch.where(self._mask(), self.blocks, fill_v)

    def ensure_zero_pad(self) -> "DsArray":
        """Self if the pad is known zero, else a re-masked copy (the single
        enforcement point of the pad-is-zero invariant)."""
        if self.pad_state.kind == "zero":
            return self
        return DsArray(self._remask(), self.grid, PAD_ZERO)

    def _with_blocks(self, blocks: torch.Tensor,
                     grid: Optional[BlockGrid] = None,
                     pad_state: PadState = PAD_ZERO) -> "DsArray":
        return DsArray(blocks, grid if grid is not None else self.grid,
                       pad_state)

    # -- materialization ------------------------------------------------------
    def collect(self) -> torch.Tensor:
        """Paper §4.2.3 ``collect``: merge the blocks into one local tensor
        (on a distributed array, a collective call: every rank gets it)."""
        if self.is_sparse:
            return self.todense().collect()
        blocks = _pl.gather(self.blocks)
        gn, gm, bn, bm = blocks.shape
        n, m = self.shape
        global_form = blocks.permute(0, 2, 1, 3).reshape(gn * bn, gm * bm)
        return global_form[:n, :m]

    # -- distribution ---------------------------------------------------------
    def distribute(self, mesh, axes: Tuple[Optional[str], Optional[str]]
                   = ("data", "model")) -> "DsArray":
        """Place the blocks on a ``DeviceMesh`` (``core.compat.make_mesh``):
        grid dim 0 sharded over the mesh axis ``axes[0]``, grid dim 1 over
        ``axes[1]`` (``None``: replicated).  The grid is first padded to
        multiples of those axes' sizes (the new blocks are pad), the
        counterpart of PyCOMPSs giving whole blocks to workers.  Every rank
        calls it with the same array (SPMD) and keeps its own shard: no
        communication, unless the array was distributed otherwise (then it
        is gathered first).  Idempotent."""
        if self.is_sparse:
            from repro_torch.core import sparse as sparse_mod
            return sparse_mod.distribute_sparse(self, mesh, axes)
        places = _pl.placements(mesh, axes)
        gn, gm = self.stacked_grid
        target = (round_up(gn, _pl.axis_size(mesh, axes[0])),
                  round_up(gm, _pl.axis_size(mesh, axes[1])))
        me = self
        if self.is_distributed:
            if (self.blocks.device_mesh == mesh and target == (gn, gm)
                    and tuple(self.blocks.placements) == places):
                return self
            me = self._gathered()
        padded = me._pad_grid_to(target)
        return DsArray(_pl.place(padded.blocks, mesh, places), self.grid,
                       padded.pad_state)

    def sharding_spec(self, axes=("data", "model")) -> tuple:
        """The mesh axis of each dim of the stacked tensor: the counterpart
        of the reference's ``P(axes[0], axes[1], None, None)``."""
        return (axes[0], axes[1], None, None)

    def _gathered(self) -> "DsArray":
        """This array with all of its blocks on this rank (an all-gather of
        a distributed array's shards; self otherwise)."""
        if not self.is_distributed:
            return self
        if self.is_sparse:
            from repro_torch.core import sparse as sparse_mod
            return sparse_mod.gather_sparse(self)
        return DsArray(_pl.gather(self.blocks), self.grid, self.pad_state)

    # -- block-format conversions (paper: NumPy OR scipy.sparse blocks) ------
    @_gathers(sparse_only=True)
    def todense(self) -> "DsArray":
        """This array with dense stacked blocks (identity when dense)."""
        from repro_torch.core import sparse as sparse_mod
        return sparse_mod.todense(self)

    @_gathers()
    def tosparse(self, nse: Optional[int] = None) -> "DsArray":
        """This array with stacked-COO blocks (identity when sparse); see
        ``core.sparse`` for the format and the op policy."""
        from repro_torch.core import sparse as sparse_mod
        return sparse_mod.tosparse(self, nse=nse)

    # -- validation -------------------------------------------------------------
    def check_invariants(self) -> "DsArray":
        """Validate the static claims against the data; raises on violation,
        returns self.  Checked: grid/shape geometry, the pad region matching
        ``pad_state`` and, for sparse blocks, indices in bounds or with zero
        data and no entry in the pad region."""
        gn, gm = self.grid.grid
        bn, bm = self.grid.block_shape
        n, m = self.shape
        if n > gn * bn or m > gm * bm:
            raise AssertionError(f"grid {self.grid} does not cover shape")
        if self.is_sparse:
            from repro_torch.core import sparse as sparse_mod
            sparse_mod.check_bcoo_invariants(self._gathered())
            return self
        sgn, sgm = self.stacked_grid
        blocks = _pl.gather(self.blocks).detach().cpu()
        if blocks.dtype == torch.bfloat16:
            blocks = blocks.float()          # numpy has no bfloat16
        g = blocks.numpy().transpose(0, 2, 1, 3).reshape(sgn * bn, sgm * bm)
        pad_mask = (np.arange(sgn * bn)[:, None] >= n) | \
                   (np.arange(sgm * bm)[None, :] >= m)
        if self.pad_state.kind == "zero":
            bad = pad_mask & (g != 0)
        elif self.pad_state.kind == "fill":
            bad = pad_mask & (g != np.asarray(self.pad_state.fill, g.dtype))
        else:
            return self
        if bad.any():
            r, c = (int(v) for v in np.argwhere(bad)[0])
            gi, bi = divmod(r, bn)
            gj, bj = divmod(c, bm)
            raise AssertionError(
                f"pad_state={self.pad_state} but pad region differs: "
                f"{int(bad.sum())} violation(s), first in block "
                f"({gi}, {gj}) at offset ({bi}, {bj}) "
                f"(global ({r}, {c}), value {g[r, c]!r})")
        return self

    def finite_report(self):
        """Block-granular NaN/Inf diagnosis (``resilience.guards``): which
        blocks hold non-finite values, with counts and the first offending
        in-block offset (dense) or entry slot (sparse).  Pad-state aware: a
        DIRTY or FILL pad region never false-positives.  Returns a
        ``FiniteReport`` (``.ok`` / ``.describe()``); blocks are named
        ``block (gi, gj)`` in the ``check_invariants`` style."""
        from repro_torch.resilience import guards
        return guards.finite_report(self._gathered())

    # -- laziness -------------------------------------------------------------
    def lazy(self) -> "LazyDsArray":
        """This array lifted into the lazy layer: later ops record an
        ``Expr`` plan that ``compute()`` optimizes (elementwise fusion, the
        transpose folded into the GEMM, plan-wide pad states) before it
        runs.  See ``core.expr`` and ``core.plan``."""
        from repro_torch.core import expr
        return expr.lift_lazy(self)

    # -- elementwise ----------------------------------------------------------
    @_recordable
    def _binary(self, other, op: Callable, reverse: bool = False) -> "DsArray":
        me = self
        if me.dtype == torch.bool and type(_scalar_operand(other)) in (int, float):
            # the reference's weak Python scalar lifts bool to the 32-bit
            # type of its kind (torch would take int64, or refuse a bool
            # operand of sub)
            me = me.astype(torch.int32 if type(_scalar_operand(other)) is int
                           else torch.float32)
        is_ds = isinstance(other, DsArray)
        # with an operand on a mesh, both are placed alike and op runs per shard
        ref = me if me.is_distributed else \
            other if is_ds and other.is_distributed else None
        if me.is_sparse or (is_ds and other.is_sparse):
            from repro_torch.core import sparse as sparse_mod
            if ref is not None:      # sparse on a mesh: on the gathered blocks
                rhs = other._gathered() if is_ds else other
                return _replace(sparse_mod.binary(me._gathered(), rhs, op, reverse),
                                ref)
            return sparse_mod.binary(me, other, op, reverse)
        if ref is not None:
            me = me.distribute(*ref.mesh_axes)
        if is_ds:
            if other.shape != self.shape:
                raise ValueError(f"shape mismatch {self.shape} vs {other.shape}")
            if other.block_shape != self.block_shape:
                other = other.rechunk(self.block_shape)
            if ref is not None:
                other = other.distribute(*ref.mesh_axes)
            if other.stacked_grid != me.stacked_grid:
                common = (max(me.stacked_grid[0], other.stacked_grid[0]),
                          max(me.stacked_grid[1], other.stacked_grid[1]))
                me = me._pad_grid_to(common)
                other = other._pad_grid_to(common)
            rhs = _pl.local(other.blocks)
            probe_rhs = (other.pad_state, other.dtype)
        else:
            rhs = _scalar_operand(other)
            if rhs is None:
                return NotImplemented
            probe_rhs = rhs
        loc = _pl.local(me.blocks)
        out = op(rhs, loc) if reverse else op(loc, rhs)
        # both pad regions hold known constants at the SAME positions, so the
        # result pad is the op of the constants — no remask, just bookkeeping
        pad = _probe_binary_pad(op, me.pad_state, me.dtype, probe_rhs, reverse)
        return DsArray(me._placed(out), BlockGrid(me.shape, me.block_shape), pad)

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
        return self.map_blocks(torch.neg)

    @_recordable
    @_gathers(sparse_only=True)
    def map_blocks(self, fn: Callable[[torch.Tensor], torch.Tensor],
                   pad: Optional[PadState] = None) -> "DsArray":
        """Apply an elementwise function to every block.  The pad state comes
        from running ``fn`` on the pad constant; non-elementwise fns pass
        ``pad=`` explicitly (``PAD_DIRTY`` when unknown).  On sparse blocks
        a zero-preserving ``fn`` maps the stored data; any other densifies."""
        if self.is_sparse:
            from repro_torch.core import sparse as sparse_mod
            return sparse_mod.map_blocks_sparse(self, fn, pad)
        loc = _pl.local(self.blocks)      # on a mesh: fn maps each shard
        out = fn(loc)
        if out.shape != loc.shape:
            raise ValueError("map_blocks must preserve block shapes")
        if pad is None:
            pad = _probe_map_pad(fn, self.pad_state, self.dtype)
        return DsArray(self._placed(out), self.grid, pad)

    def sqrt(self) -> "DsArray":
        return self.map_blocks(torch.sqrt)

    def exp(self) -> "DsArray":
        return self.map_blocks(torch.exp)

    def abs(self) -> "DsArray":
        return self.map_blocks(torch.abs)

    @_recordable
    @_gathers(sparse_only=True)
    def astype(self, dtype: torch.dtype) -> "DsArray":
        if self.is_sparse:
            from repro_torch.core import sparse as sparse_mod
            return sparse_mod.astype_sparse(self, dtype)
        pad = self.pad_state
        if pad.kind == "fill":
            # the physical pad is cast too; re-derive the constant the same way
            pad = pad_state_of(_cast(torch.tensor(pad.fill, dtype=self.dtype), dtype))
        out = _cast(_pl.local(self.blocks), dtype)
        return DsArray(self._placed(out), self.grid, pad)

    def _placed(self, loc: torch.Tensor) -> torch.Tensor:
        """``loc``, a shard-wise result of the same shape as this rank's
        shard, placed as the blocks are (``loc`` itself when not
        distributed)."""
        return _pl.rewrap(loc, self.blocks) if self.is_distributed else loc

    # -- structural ops ---------------------------------------------------------
    @_recordable
    @_gathers(sparse_only=True)
    def transpose(self) -> "DsArray":
        """Paper §5.2: per-block transpose + block-grid permutation.  Returns
        a permuted VIEW of the stacked tensor (no copy); the GEMM kernel
        reads it through its strides.  Sparse blocks swap their grid dims
        and each entry's indices: O(nnz).  On a mesh each rank permutes its
        shard (no communication) and the result has the mirrored placement,
        as the reference's ``P(axes[1], axes[0])``; ``shmap_ops.transpose_pp``
        gives the unmirrored one."""
        if self.is_sparse:
            from repro_torch.core import sparse as sparse_mod
            return sparse_mod.transpose_sparse(self)
        out = _pl.local(self.blocks).permute(1, 0, 3, 2)
        if self.is_distributed:
            b = self.blocks
            gn, gm, bn, bm = b.shape
            out = _pl.wrap(out, b.device_mesh, _pl.mirrored(b.placements),
                           (gm, gn, bm, bn))
        return DsArray(out, self.grid.transpose(), self.pad_state)

    def _pad_grid_to(self, stacked_grid: Tuple[int, int]) -> "DsArray":
        if self.is_distributed and tuple(stacked_grid) != self.stacked_grid:
            # the shards change: grow the gathered grid, place it exactly
            me = self._gathered()._pad_grid_to(stacked_grid)
            if me.is_sparse:
                from repro_torch.core import sparse as sparse_mod
                return sparse_mod.place_sparse(me, self._leaf.device_mesh,
                                               self._leaf.placements)
            return DsArray(_pl.place(me.blocks, self.blocks.device_mesh,
                                     self.blocks.placements), me.grid, me.pad_state)
        if self.is_sparse:
            from repro_torch.core import sparse as sparse_mod
            return sparse_mod.pad_grid_sparse(self, stacked_grid)
        gn, gm = self.stacked_grid
        tn, tm = stacked_grid
        if (tn, tm) == (gn, gm):
            return self
        if tn < gn or tm < gm:
            raise ValueError("can only grow the stacked grid")
        # grow with the array's own pad constant so the pad state survives
        cv = 0 if self.pad_state.kind != "fill" else self.pad_state.fill
        out = torch.full((tn, tm) + tuple(self.blocks.shape[2:]), cv,
                         dtype=self.dtype, device=self.device)
        out[:gn, :gm] = self.blocks
        return DsArray(out, self.grid, self.pad_state)

    @_recordable
    def rechunk(self, block_shape: Tuple[int, int]) -> "DsArray":
        """Re-block to a new block size without a global ``(n, m)`` tensor
        (see ``core.structural.rechunk``)."""
        from repro_torch.core import structural
        return structural.rechunk(self, tuple(block_shape))

    def __matmul__(self, other: "DsArray") -> "DsArray":
        """Blocked matmul: C[i,j] = sum_k A[i,k] @ B[k,j], one launch of the
        stacked GEMM over (grid-k, block-k).  Zero pads on both operands make
        the padded contraction exact, so the result pad is zero.  A sparse
        left operand contracts its stored entries (``local_matmul``'s sparse
        dispatch); a sparse right operand densifies.

        With an operand on a mesh, the blocks never reach the kernel as a
        DTensor: two dense operands whose placement shards both grid dims
        run ``shmap_ops.summa_matmul`` on that mesh and axes (every shard's
        product one ``stacked_matmul`` launch; the result stays on the mesh,
        placed as the operand); any other pair (a replicated axis, sparse
        blocks) multiplies the gathered operands and places the product as
        the distributed operand is."""
        from repro_torch.kernels.matmul.ops import local_matmul
        if _lazy_mode():
            from repro_torch.core import expr
            if isinstance(other, (DsArray, expr.LazyDsArray)):
                return expr.lift_lazy(self) @ other
        if not isinstance(other, DsArray):
            return NotImplemented
        if self.is_distributed or other.is_distributed:
            return _matmul_placed(self, other)
        if other.is_sparse:
            other = other.todense()
        if self.shape[1] != other.shape[0]:
            raise ValueError(f"matmul shape mismatch {self.shape} @ {other.shape}")
        if self.block_shape[1] != other.block_shape[0]:
            other = other.rechunk((self.block_shape[1], other.block_shape[1]))
        if self.stacked_grid[1] != other.stacked_grid[0]:
            k = max(self.stacked_grid[1], other.stacked_grid[0])
            a = self._pad_grid_to((self.stacked_grid[0], k))
            b = other._pad_grid_to((k, other.stacked_grid[1]))
        else:
            a, b = self, other
        a, b = a.ensure_zero_pad(), b.ensure_zero_pad()
        out = local_matmul(a.blocks, b.blocks,
                           out_dtype=torch.promote_types(a.dtype, b.dtype))
        grid = BlockGrid((self.shape[0], other.shape[1]),
                         (self.block_shape[0], other.block_shape[1]))
        return DsArray(out, grid, PAD_ZERO)

    # -- reductions ---------------------------------------------------------
    @_recordable
    @_gathers(sparse_only=True)
    def _reduce(self, op: str, axis: Optional[int]):
        """On a mesh each rank reduces its shard and the partials are
        all-reduced over the mesh axes of the reduced grid dims: the result
        is replicated there (a 0-d tensor on every rank for ``axis=None``)."""
        if self.is_sparse:
            from repro_torch.core import sparse as sparse_mod
            return sparse_mod.reduce_sparse(self, op, axis)
        integral = not (self.dtype.is_floating_point or self.dtype.is_complex)
        if integral and self.dtype != torch.bool:
            info = torch.iinfo(self.dtype)
            fill = {"sum": 0, "max": int(info.min), "min": int(info.max)}[op]
        else:
            fill = {"sum": 0, "max": -float("inf"), "min": float("inf")}[op]
        # a pad that is not already the reduction identity is remasked on a
        # mesh (each rank its shard); on one device the reduce reads the
        # valid elements alone and writes no masked copy
        ps = self.pad_state
        identity = (ps.kind == "zero" and fill == 0) or \
            (ps.kind == "fill" and ps.fill == fill)
        valid_only = not identity and not self.is_distributed \
            and min(self.shape) > 0
        x = self.blocks if identity or valid_only else self._remask(fill)
        unsigned = False
        if op == "sum":
            # 32-bit integer accumulators, as the reference's sums: uint32
            # for unsigned types (torch has no uint32 sum: int64, wrapped)
            unsigned = integral and self.dtype != torch.bool \
                and not self.dtype.is_signed
            acc = torch.int64 if unsigned else torch.int32 if integral else None
            red = lambda t, dims=None: (t.sum(dtype=acc) if dims is None
                                        else t.sum(dim=dims, dtype=acc))
        else:
            f = torch.amax if op == "max" else torch.amin
            red = lambda t, dims=None: f(t) if dims is None else f(t, dim=dims)
        if valid_only:
            combine = {"sum": torch.add, "max": torch.maximum,
                       "min": torch.minimum}[op]
            red = _valid_reduce(red, combine, self.shape, fill)
        xl = _pl.local(x)

        def total(part, dims):
            """The partial reduced over the shards of grid dims ``dims``."""
            if self.is_distributed:
                part = _pl.reduce_shards(part.contiguous(), x, dims, op)
            return part.to(torch.uint32) if unsigned else part

        if axis is None:
            return total(red(xl), (0, 1))
        if axis not in (0, 1):
            raise ValueError(f"axis must be 0, 1 or None, got {axis}")
        # paper Fig. 5: one task per column (axis 0) or row (axis 1) of blocks
        out = total(red(xl, (0, 2) if axis == 0 else (1, 3)), (axis,))
        g, b = out.shape
        if axis == 0:
            blocks = out.reshape(1, g, 1, b)
            grid = BlockGrid((1, self.shape[1]), (1, b))
        else:
            blocks = out.reshape(g, 1, b, 1)
            grid = BlockGrid((self.shape[0], 1), (b, 1))
        if self.is_distributed:
            gn, gm = self.stacked_grid
            shape = (1, gm, 1, b) if axis == 0 else (gn, 1, b, 1)
            blocks = _pl.wrap(blocks, x.device_mesh,
                              _pl.reduced(x.placements, (axis,)), shape)
        # pad lines of the result reduce over identity-only values
        return DsArray(blocks, grid, pad_state_of(fill))

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
            # promote BEFORE summing: an integer accumulator overflows
            me = self.astype(torch.promote_types(self.dtype, torch.float32))
        s = me.sum(axis)
        if isinstance(s, DsArray):
            return s / float(denom)
        return s / denom

    @_recordable
    def norm(self, axis: Optional[int] = None):
        """Euclidean norm along an axis (the paper's ``w.norm(axis=1)``),
        through :func:`apply_along_axis`; ``axis=None`` is the norm of all
        elements, a square and a sum."""
        if axis is None:
            sq = self._binary(self, torch.mul)  # x*x keeps pad zero
            return torch.sqrt(sq.sum())
        return apply_along_axis(lambda v: torch.sqrt(torch.sum(v * v)), axis,
                                self)

    # -- indexing ------------------------------------------------------------
    @_recordable
    def __getitem__(self, key) -> "DsArray":
        """NumPy-style indexing returning a new ds-array (paper §4.2.3):
        ``A[r]``, ``A[r0:r1]``, ``A[r0:r1, c0:c1]``, integer rows/cols and
        integer-array row selection, lowered to block-native ops."""
        from repro_torch.core import structural
        return structural.getitem(self, key)


# ---------------------------------------------------------------------------
# Derived block-native routines
# ---------------------------------------------------------------------------


def _matmul_placed(a: DsArray, b: DsArray) -> DsArray:
    """``a @ b`` with an operand on a mesh (see ``DsArray.__matmul__``)."""
    from repro_torch.core import shmap_ops
    ref = a if a.is_distributed else b
    mesh, axes = ref.mesh_axes
    if a.is_sparse or b.is_sparse or None in axes:
        return _replace(a._gathered() @ b._gathered(), ref)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shape mismatch {a.shape} @ {b.shape}")
    if a.block_shape[1] != b.block_shape[0]:
        b = b.rechunk((a.block_shape[1], b.block_shape[1]))
    dt = torch.promote_types(a.dtype, b.dtype)
    return shmap_ops.summa_matmul(a.astype(dt), b.astype(dt), mesh, axes)


def matmul_ta(a: DsArray, b: DsArray) -> DsArray:
    """``Aᵀ @ B`` with the transpose folded into the GEMM: ``a`` stays in its
    untransposed stacked layout and ``local_matmul`` reads it transposed
    (a sparse ``a`` is contracted by its stored entries; a sparse ``b``
    densifies).  With an operand on a mesh, two dense operands run
    ``shmap_ops.matmul_ta_psum`` on that operand's mesh and axes (each
    rank's block rows in one ``stacked_matmul`` launch, the partials
    all-reduced); a sparse one multiplies the gathered operands and places
    the product as the distributed operand is."""
    from repro_torch.core import structural
    from repro_torch.kernels.matmul.ops import local_matmul
    if not isinstance(b, DsArray):
        raise TypeError("matmul_ta wants DsArray operands")
    if a.is_distributed or b.is_distributed:
        ref = a if a.is_distributed else b
        if a.is_sparse or b.is_sparse:
            return _replace(matmul_ta(a._gathered(), b._gathered()), ref)
        from repro_torch.core import shmap_ops
        if a.block_shape[0] != b.block_shape[0]:
            b = b.rechunk((a.block_shape[0], b.block_shape[1]))
        return shmap_ops.matmul_ta_psum(a, b, *ref.mesh_axes)
    if b.is_sparse:
        b = b.todense()
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"matmul_ta shape mismatch {a.shape}ᵀ @ {b.shape}")
    if a.block_shape[0] != b.block_shape[0]:
        b = structural.rechunk(b, (a.block_shape[0], b.block_shape[1]))
    if a.stacked_grid[0] != b.stacked_grid[0]:
        k = max(a.stacked_grid[0], b.stacked_grid[0])
        a = a._pad_grid_to((k, a.stacked_grid[1]))
        b = b._pad_grid_to((k, b.stacked_grid[1]))
    a, b = a.ensure_zero_pad(), b.ensure_zero_pad()
    out = local_matmul(a.blocks, b.blocks,
                       out_dtype=torch.promote_types(a.dtype, b.dtype),
                       transpose_a=True)
    grid = BlockGrid((a.shape[1], b.shape[1]),
                     (a.block_shape[1], b.block_shape[1]))
    return DsArray(out, grid, PAD_ZERO)


def apply_along_axis(fn: Callable[[torch.Tensor], torch.Tensor], axis: int,
                     a: DsArray) -> DsArray:
    """Paper §4.2.3 ``apply_along_axis``: ``fn`` over every 1-D slice
    (``axis=1`` rows, ``axis=0`` columns); ``fn`` maps a vector to a scalar
    or to a vector of fixed length.  The stacked tensor is regrouped so
    that each slice is contiguous in a rank-3 block layout (grid dim first,
    never the rank-2 ``(n, m)`` form) and ``fn`` runs as one
    ``vmap(vmap(fn))`` over all of them; results of all-pad slices are
    masked to zero.  On a distributed ``a`` it runs on the gathered blocks
    and places the result as ``a`` is."""
    from repro_torch.core import structural
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if a.is_distributed:
        return _replace(apply_along_axis(fn, axis, a._gathered()), a)
    a2 = a.ensure_zero_pad()
    if a2.is_sparse:
        a2 = a2.todense()      # per-slice fns need the dense block layout
    gn, gm, bn, bm = a2.blocks.shape
    n, m = a2.shape
    each = torch.func.vmap(torch.func.vmap(fn))
    if axis == 1:
        out = each(a2.blocks.permute(0, 2, 1, 3).reshape(gn, bn, gm * bm)[..., :m])
    else:
        out = each(a2.blocks.permute(1, 3, 0, 2).reshape(gm, bm, gn * bn)[..., :n])
    if out.ndim not in (2, 3):
        raise ValueError("fn must return a scalar or 1-D vector")
    if out.ndim == 2:
        out = out[..., None]
    k = out.shape[-1]
    if axis == 1:
        blocks = out[:, None]                           # (gn, 1, bn, k)
        if gn * bn > n:
            blocks = structural._mask_axes(blocks, n=n)
        return DsArray(blocks, BlockGrid((n, k), (bn, k)), PAD_ZERO)
    blocks = out.permute(0, 2, 1)[None]                 # (1, gm, k, bm)
    if gm * bm > m:
        blocks = structural._mask_axes(blocks, m=m)
    return DsArray(blocks, BlockGrid((k, m), (k, bm)), PAD_ZERO)


def concat_rows(arrays: Sequence) -> DsArray:
    """Vertical concatenation (the paper's Dataset ``append``, generalised):
    a stack of block grids when part row counts align to the block size,
    a per-block gather otherwise (``core.structural.concat_rows``).  Records
    a plan node when recording is armed or any part is lazy."""
    arrays = list(arrays)
    expr_m = sys.modules.get("repro_torch.core.expr")
    if _lazy_mode() or (expr_m is not None and
                        any(isinstance(a, expr_m.LazyDsArray) for a in arrays)):
        return expr_m.record_concat(arrays)
    from repro_torch.core import structural
    return structural.concat_rows(arrays)


# ---------------------------------------------------------------------------
# Creation routines (paper §4.2.2)
# ---------------------------------------------------------------------------


def from_array(arr, block_shape: Tuple[int, int], device="cuda") -> DsArray:
    """Block a local 2-D array (NumPy or torch) into a ds-array on ``device``."""
    dev = resolve_device(device)
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(np.asarray(arr))
    t = t.to(device=dev, dtype=_NARROW.get(t.dtype, t.dtype))
    if t.ndim == 1:
        t = t.reshape(-1, 1)
    if t.ndim != 2:
        raise ValueError(f"ds-arrays are 2-D, got shape {tuple(t.shape)}")
    grid = BlockGrid(tuple(t.shape), tuple(block_shape))
    (gn, gm), (bn, bm) = grid.grid, grid.block_shape
    pn, pm = grid.padded_shape
    padded = torch.zeros((pn, pm), dtype=t.dtype, device=dev)
    padded[:t.shape[0], :t.shape[1]] = t
    blocks = padded.reshape(gn, bn, gm, bm).permute(0, 2, 1, 3).contiguous()
    return DsArray(blocks, grid)


def zeros(shape: Tuple[int, int], block_shape: Tuple[int, int],
          dtype=torch.float32, device="cuda") -> DsArray:
    grid = BlockGrid(tuple(shape), tuple(block_shape))
    return DsArray(torch.zeros(grid.stacked_shape, dtype=dtype,
                               device=resolve_device(device)), grid)


def full(shape, block_shape, fill_value, dtype=torch.float32,
         device="cuda") -> DsArray:
    grid = BlockGrid(tuple(shape), tuple(block_shape))
    blocks = torch.full(grid.stacked_shape, fill_value, dtype=dtype,
                        device=resolve_device(device))
    return DsArray(blocks, grid, pad_state_of(blocks.reshape(-1)[0]))


def eye(n: int, block_shape: Tuple[int, int], dtype=torch.float32,
        device="cuda") -> DsArray:
    dev = resolve_device(device)
    grid = BlockGrid((n, n), tuple(block_shape))
    gn, gm, bn, bm = grid.stacked_shape
    row = torch.arange(gn * bn, device=dev).reshape(gn, 1, bn, 1)
    col = torch.arange(gm * bm, device=dev).reshape(1, gm, 1, bm)
    blocks = ((row == col) & (row < n)).to(dtype)
    return DsArray(blocks, grid)


def random_array(generator: torch.Generator, shape: Tuple[int, int],
                 block_shape: Tuple[int, int], dtype=torch.float32,
                 distribution: str = "uniform", device="cuda") -> DsArray:
    """Paper §4.2.2 ``random_array``: uniform [0, 1) or standard normal
    values from ``generator`` (which must live on ``device``), pad zero.
    Held to its distribution, not to the reference's random bits."""
    dev = resolve_device(device)
    grid = BlockGrid(tuple(shape), tuple(block_shape))
    sampler = {"uniform": torch.rand, "normal": torch.randn}[distribution]
    blocks = sampler(grid.stacked_shape, generator=generator, dtype=dtype,
                     device=dev)
    res = DsArray(blocks, grid)
    return res._with_blocks(res._remask())


def identity_like(a: DsArray) -> DsArray:
    """The identity with ``a``'s shape, block shape, dtype and device."""
    if a.shape[0] != a.shape[1]:
        raise ValueError("identity_like needs a square array")
    return eye(a.shape[0], a.block_shape, a.dtype, device=a.device)
