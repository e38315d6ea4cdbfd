"""Block-granular numerical guards for ds-arrays and plan outputs (the port
of ``repro.resilience.guards``).

One NaN in one block propagates through every GEMM it touches and a fit
silently converges to garbage, so the guards are block-granular: not
"there is a NaN somewhere in 2 GB" but "block (3, 1) at offset (2, 7)".
Three levels, cheapest first:

* :func:`all_finite` — ONE reduction over an array on its device
  (pad-state aware: a DIRTY or non-finite FILL pad is masked out first);
  the post-condition ``run_resilient(..., guard="finite")`` runs;
* :func:`finite_report` — the block-granular diagnosis: per-block NaN/Inf
  counts with the first offending in-block offset (dense) or entry slot
  (stacked COO), reduced on the device so only the bad blocks' numbers
  reach the host (``DsArray.finite_report()`` delegates here);
* :func:`require_finite_host` — for small host-side arrays (solver
  outputs).

All failures raise :class:`NumericalDivergence`, which carries the report;
``run_resilient`` classifies it as deterministic (retrying a NaN recomputes
the NaN).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dsarray import DsArray


class NumericalDivergence(ArithmeticError):
    """A guarded value contains NaN/Inf.  ``report`` holds the
    :class:`FiniteReport` (None for host-array and scalar guards)."""

    def __init__(self, message: str, report: Optional["FiniteReport"] = None):
        super().__init__(message)
        self.report = report


@dataclasses.dataclass(frozen=True)
class BadBlock:
    """One offending block: coordinate, counts, and the first bad site
    (dense: in-block offset; stacked COO: entry slot)."""

    gi: int
    gj: int
    n_nan: int
    n_inf: int
    first: Tuple[int, ...]      # (bi, bj) dense offset | (slot,) sparse
    sparse: bool = False

    def describe(self) -> str:
        what = []
        if self.n_nan:
            what.append(f"{self.n_nan} nan")
        if self.n_inf:
            what.append(f"{self.n_inf} inf")
        site = (f"slot {self.first[0]}" if self.sparse
                else f"offset {self.first}")
        return f"block ({self.gi}, {self.gj}): {' + '.join(what)}, " \
               f"first at {site}"


@dataclasses.dataclass(frozen=True)
class FiniteReport:
    """Block-granular finiteness report for one ds-array."""

    shape: Tuple[int, int]
    block_format: str
    bad_blocks: Tuple[BadBlock, ...]

    @property
    def ok(self) -> bool:
        return not self.bad_blocks

    def describe(self) -> str:
        if self.ok:
            return f"all finite ({self.block_format} {self.shape})"
        lines = "; ".join(b.describe() for b in self.bad_blocks[:8])
        more = len(self.bad_blocks) - 8
        if more > 0:
            lines += f"; ... {more} more block(s)"
        return (f"non-finite values in {len(self.bad_blocks)} block(s) of "
                f"{self.block_format} ds-array {self.shape}: {lines}")


def _bad_blocks(nan: torch.Tensor, inf: torch.Tensor, sparse: bool
                ) -> Tuple[BadBlock, ...]:
    """BadBlocks of ``(sgn, sgm, ...)`` NaN/Inf masks, in row-major block
    order: the counts and each bad block's first site are reduced on the
    device; only the bad blocks' numbers reach the host."""
    bad = nan | inf
    flat = bad.reshape(bad.shape[0], bad.shape[1], -1)
    coords = torch.nonzero(flat.any(-1)).tolist()
    if not coords:
        return ()
    gi, gj = (torch.tensor(c, device=bad.device) for c in zip(*coords))
    n_nan = nan.reshape(flat.shape)[gi, gj].sum(-1).tolist()
    n_inf = inf.reshape(flat.shape)[gi, gj].sum(-1).tolist()
    first = flat[gi, gj].to(torch.int8).argmax(-1).tolist()    # row-major
    inner = bad.shape[2:]
    out = []
    for (i, j), nn, ni, f in zip(coords, n_nan, n_inf, first):
        site = (f,) if sparse else tuple(int(v) for v in np.unravel_index(f, inner))
        out.append(BadBlock(int(i), int(j), int(nn), int(ni), site, sparse=sparse))
    return tuple(out)


def finite_report(a: DsArray) -> FiniteReport:
    """Per-block NaN/Inf diagnosis (pad-state aware).

    Dense: only positions inside the logical shape count — a DIRTY pad
    holding NaN is the pad's business, not a divergence.  Stacked COO:
    every stored entry counts (a sentinel slot holds zero data, so only
    real entries can be bad), reported as ``block (gi, gj) slot k``.
    """
    if a.is_sparse:
        data = a.blocks.data                               # (gn, gm, nse)
        return FiniteReport(a.shape, "bcoo", _bad_blocks(
            torch.isnan(data), torch.isinf(data), sparse=True))
    g = a.blocks
    valid = a._mask()
    return FiniteReport(a.shape, "dense", _bad_blocks(
        torch.isnan(g) & valid, torch.isinf(g) & valid, sparse=False))


def _pad_is_finite(a: DsArray) -> bool:
    """True when the pad region is known finite (so raw blocks can be
    checked without a mask pass)."""
    ps = a.pad_state
    if ps.kind == "zero":
        return True
    if ps.kind == "fill":
        return bool(math.isfinite(float(ps.fill)))
    return False


def all_finite(value) -> bool:
    """ONE finiteness reduction over a ds-array / tensor / scalar, on its
    device.  For a ds-array whose pad is known finite it is
    ``isfinite(blocks).all()`` on the raw stacked tensor (no mask pass); a
    DIRTY pad masks first, so an unknown pad region never false-positives.
    """
    if isinstance(value, DsArray):
        if value.is_sparse:
            return bool(torch.isfinite(value.blocks.data).all())
        blocks = value.blocks if _pad_is_finite(value) else value._remask()
        return bool(torch.isfinite(blocks).all())
    t = value if isinstance(value, torch.Tensor) else \
        torch.as_tensor(np.asarray(value))
    if not (t.dtype.is_floating_point or t.dtype.is_complex):
        return True
    return bool(torch.isfinite(t).all())


def guard_finite(*values, what: str = "plan output"):
    """Post-condition: every value is finite, else
    :class:`NumericalDivergence`.

    Clean path cost: one reduction per value.  On failure the
    block-granular :func:`finite_report` is built (only then) and its
    coordinates go into the error message.  Integer values pass for free.
    Returns the values (a single value un-tupled) for chaining.
    """
    for i, v in enumerate(values):
        if isinstance(v, DsArray):
            if v.dtype.is_floating_point and not all_finite(v):
                rep = finite_report(v)
                raise NumericalDivergence(
                    f"{what}[{i}]: {rep.describe()}", rep)
        elif not all_finite(v):
            shown = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
            raise NumericalDivergence(
                f"{what}[{i}]: non-finite scalar/array value {shown!r}")
    return values[0] if len(values) == 1 else values


def require_finite_host(arr: np.ndarray, what: str) -> np.ndarray:
    """Small host-side arrays (solver outputs): raise on NaN/Inf.  Callers
    that treat divergence as a fallback trigger catch
    :class:`NumericalDivergence` alongside ``LinAlgError``."""
    a = np.asarray(arr)
    if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
        n_nan = int(np.isnan(a).sum())
        n_inf = int(np.isinf(a).sum())
        raise NumericalDivergence(
            f"{what}: {n_nan} nan + {n_inf} inf in shape {a.shape}")
    return arr


def poison_block(a: DsArray, block: Tuple[int, int],
                 value: float = math.nan) -> DsArray:
    """``a`` with ``value`` written into one position of block ``block`` —
    the fault-injection side of the guards (dense: offset (0, 0) of the
    block; stacked COO: entry slot 0 of the block).  ``run_resilient``
    applies armed poison specs with it."""
    gi, gj = block
    sgn, sgm = a.stacked_grid
    if not (0 <= gi < sgn and 0 <= gj < sgm):
        raise ValueError(f"block {block} outside stacked grid {(sgn, sgm)}")
    if a.is_sparse:
        from repro_torch.core.sparse import _rebuild
        data = a.blocks.data.clone()
        data[gi, gj, 0] = value
        return DsArray(_rebuild(a.blocks, data), a.grid, a.pad_state)
    blocks = a.blocks.clone()
    blocks[gi, gj, 0, 0] = value
    return DsArray(blocks, a.grid, a.pad_state)
