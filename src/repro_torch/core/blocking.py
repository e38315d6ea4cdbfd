"""Block-grid geometry for ds-arrays.

The paper's ds-array is a 2-D array divided into blocks of an arbitrary,
user-chosen size ``(bn, bm)``; blocks are the unit of distribution and of
parallel work.  This module holds the pure geometry: grid shape, padded
extents, per-block logical extents, and divisibility padding needed to lay a
block grid onto a device mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


@dataclasses.dataclass(frozen=True)
class BlockGrid:
    """Geometry of a 2-D array of shape ``shape`` cut into ``block_shape`` tiles.

    Edge blocks may be logically smaller (the paper: "rightmost blocks and the
    blocks at the bottom can be smaller"); physically every block is stored at
    full ``block_shape`` with a zero pad, and masks recover logical extents.
    """

    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    def __post_init__(self):
        n, m = self.shape
        bn, bm = self.block_shape
        if n < 0 or m < 0:
            raise ValueError(f"negative array shape {self.shape}")
        if bn <= 0 or bm <= 0:
            raise ValueError(f"non-positive block shape {self.block_shape}")

    # -- grid extents -------------------------------------------------------
    @property
    def grid(self) -> Tuple[int, int]:
        n, m = self.shape
        bn, bm = self.block_shape
        return (max(1, ceil_div(n, bn)), max(1, ceil_div(m, bm)))

    @property
    def n_blocks(self) -> int:
        gn, gm = self.grid
        return gn * gm

    @property
    def padded_shape(self) -> Tuple[int, int]:
        gn, gm = self.grid
        bn, bm = self.block_shape
        return (gn * bn, gm * bm)

    @property
    def stacked_shape(self) -> Tuple[int, int, int, int]:
        """Shape of the stacked block tensor (gn, gm, bn, bm)."""
        gn, gm = self.grid
        bn, bm = self.block_shape
        return (gn, gm, bn, bm)

    # -- per-block logical extents ------------------------------------------
    def block_extent(self, i: int, j: int) -> Tuple[int, int]:
        """Logical (rows, cols) stored in block (i, j)."""
        n, m = self.shape
        bn, bm = self.block_shape
        rows = min(bn, n - i * bn)
        cols = min(bm, m - j * bm)
        return (max(0, rows), max(0, cols))

    def block_slices(self, i: int, j: int) -> Tuple[slice, slice]:
        n, m = self.shape
        bn, bm = self.block_shape
        return (
            slice(i * bn, min(n, (i + 1) * bn)),
            slice(j * bm, min(m, (j + 1) * bm)),
        )

    # -- mesh layout ----------------------------------------------------------
    def mesh_padded_grid(self, mesh_shape: Tuple[int, int]) -> Tuple[int, int]:
        """Grid extents rounded up to multiples of the mesh axes, so each
        device owns the same number of whole blocks (the SPMD analogue of the
        PyCOMPSs scheduler assigning blocks to workers)."""
        gn, gm = self.grid
        dn, dm = mesh_shape
        return (round_up(gn, dn), round_up(gm, dm))

    def transpose(self) -> "BlockGrid":
        return BlockGrid(self.shape[::-1], self.block_shape[::-1])

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"BlockGrid(shape={self.shape}, block={self.block_shape}, "
            f"grid={self.grid})"
        )


# ---------------------------------------------------------------------------
# Slice / regroup geometry (pure integer math used by core.structural).
# ---------------------------------------------------------------------------


def is_aligned_slice(s: slice, size: int, block: int) -> bool:
    """True iff ``s`` selects a contiguous range starting on a block boundary
    with unit step — the case a slice is a pure block-grid slice + edge remask."""
    start, stop, step = s.indices(size)
    return step == 1 and start % block == 0 and stop >= start


def grid_span(start: int, stop: int, block: int) -> Tuple[int, int]:
    """Half-open range of grid indices whose blocks cover rows [start, stop)."""
    if stop <= start:
        return (start // block, start // block + 1)  # empty -> keep one block
    return (start // block, ceil_div(stop, block))


def can_regroup(old: Tuple[int, int], new: Tuple[int, int]) -> bool:
    """True iff block shape ``old`` reaches ``new`` by a pure regroup reshape
    (per axis, one size evenly divides the other — split or merge); otherwise
    a gather-based repack is required."""
    return all(o % n == 0 or n % o == 0 for o, n in zip(old, new))


def compatible_for_elementwise(a: BlockGrid, b: BlockGrid) -> bool:
    return a.shape == b.shape and a.block_shape == b.block_shape


def compatible_for_matmul(a: BlockGrid, b: BlockGrid) -> bool:
    return a.shape[1] == b.shape[0] and a.block_shape[1] == b.block_shape[0]
