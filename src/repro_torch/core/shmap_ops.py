"""Explicitly scheduled collective versions of ds-array ops (the port of
``repro.core.shmap_ops``).

The reference writes each of these as a ``shard_map`` body with explicit
``jax.lax`` collectives.  Here a body is a function of this rank's shards
(``DTensor.to_local()``) with explicit ``torch.distributed`` calls on the
process group of a mesh dim (``mesh.get_group(axis)``), and the result is
the DTensor of the output shards on the same mesh:

* ``summa_matmul`` — SUMMA (gather form): all-gather the A panel along the
  ``axes[1]`` mesh dim and the B panel along ``axes[0]``, then one local
  GEMM.  Bytes per rank: n·k/dn + k·m/dm elements.
* ``cannon_matmul`` — Cannon's algorithm on a square mesh: one skew
  exchange, then d − 1 nearest-neighbour shifts of both operands, a local
  GEMM after each (``batch_isend_irecv`` pairs; a rank's exchange with
  itself is no exchange, so a 1 x 1 mesh moves nothing).
* ``transpose_pp`` — a local per-shard transpose and ONE mirrored exchange
  across the square mesh: every shard moves once.
* ``colsum_psum`` — paper Fig. 5: per-rank column-of-blocks partial sums,
  one all-reduce over the ``axes[0]`` mesh dim.
* ``matmul_ta_psum`` — ``Aᵀ @ B`` of operands placed alike: each rank's
  block rows gathered along ``axes[1]``, one local GEMM with the
  transpose folded in, the partials all-reduced over ``axes[0]``.

``jax.lax.all_gather(tiled=True)`` is ``dist.all_gather`` plus a
concatenation, ``ppermute`` a pair of ``isend``/``irecv`` with global peer
ranks (read off ``mesh.mesh``), ``psum`` ``dist.all_reduce``.  Every
shard's product is ``_local_gemm``: ``local_matmul`` on the local tensors,
so on the card each is one ``stacked_matmul`` launch on the route
``kernels.matmul.kernel.plan`` gives it; the collectives are NCCL's on a
``"cuda"`` mesh and gloo's on a ``"cpu"`` one, outside any kernel.

The reference is single-controller: one program drives every device.  The
port is SPMD: every rank calls these functions (and ``collect()``, the
reductions) with the same arguments, each holding the same input array,
and keeps its own shard of the result.

Ops on a distributed array that run on the gathered blocks (every rank
all-gathers the whole array) and place their result back on the mesh,
where the reference leaves the schedule to XLA: ``_pad_grid_to`` to a grid
that changes the shards, the structural ops (``getitem``, ``take_rows``,
``take_cols``, ``rechunk``, ``concat_rows``; hence ``slice_sharded``,
``rechunk_sharded``, ``concat_rows_sharded``),
``apply_along_axis`` (so ``norm(axis)``), ``@`` with a replicated axis,
``gram`` (a tensor on every rank), and every op on sparse blocks but
``todense``/``collect``.  The elementwise ops, ``map_blocks``, ``astype``,
``transpose``, the reductions, ``@`` of dense operands sharded on both
grid dims (``summa_matmul``) and ``matmul_ta`` of dense operands
(``matmul_ta_psum``) work shard by shard.

On ``meta`` shards (``core.placement``) every collective here returns the
shape it would deliver and moves nothing: the lazy layer infers a recorded
node's metadata by running its eager op on them.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import placement as _pl
from repro_torch.core import structural
from repro_torch.core.blocking import BlockGrid, round_up
from repro_torch.core.dsarray import DsArray

Axes = Tuple[Optional[str], Optional[str]]


def _local_gemm(a: torch.Tensor, b: torch.Tensor,
                gemm: Optional[Callable] = None) -> torch.Tensor:
    """Local blocked GEMM on stacked shards: (gi,gk,bn,bk) x (gk,gj,bk,bm).

    ``gemm=None`` goes through ``kernels.matmul.ops.local_matmul``: one
    ``stacked_matmul`` launch on the card (the whole shard in one fp32
    accumulation), the plain version on the CPU.  A callable takes the two
    stacked tensors.  The reference's backend names ("pallas",
    "interpret", "einsum") choose TPU lowerings and have no counterpart."""
    from repro_torch.kernels.matmul.ops import local_matmul
    if callable(gemm):
        return gemm(a, b)
    if gemm is not None:
        raise ValueError(f"gemm={gemm!r}: pass None (the kernel on the card, "
                         f"the plain version on the CPU) or a callable; the "
                         f"reference's backend names choose TPU lowerings")
    return local_matmul(a, b, out_dtype=a.dtype)


def _sizes(mesh, axes: Axes) -> Tuple[int, int]:
    """The sizes of the two mesh axes a schedule runs over."""
    if None in axes:
        raise ValueError(f"a collective schedule runs over two mesh axes, "
                         f"got {axes}")
    return _pl.axis_size(mesh, axes[0]), _pl.axis_size(mesh, axes[1])


def _rank_at(mesh, axes: Axes, i: int, j: int) -> int:
    """The global rank at mesh coordinate ``i`` on ``axes[0]`` and ``j`` on
    ``axes[1]`` (this rank's coordinates on any other mesh dim)."""
    names = mesh.mesh_dim_names
    coord = list(mesh.get_coordinate())
    coord[names.index(axes[0])] = i
    coord[names.index(axes[1])] = j
    return int(mesh.mesh[tuple(coord)])


def _coords(mesh, axes: Axes) -> Tuple[int, int]:
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    return coord[names.index(axes[0])], coord[names.index(axes[1])]


def _exchange(t: torch.Tensor, send_to: int, recv_from: int) -> torch.Tensor:
    """One step of a ``ppermute``: send ``t`` to global rank ``send_to`` and
    return the tensor of the same shape received from ``recv_from``."""
    if send_to == recv_from == dist.get_rank() or t.device.type == "meta":
        return t
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    ops = [dist.P2POp(dist.isend, t.contiguous(), send_to),
           dist.P2POp(dist.irecv, out, recv_from)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _result(loc: torch.Tensor, mesh, axes: Axes, shape) -> torch.Tensor:
    """Output shards ``loc`` as the DTensor placed ``(axes[0], axes[1])``."""
    return _pl.wrap(loc, mesh, _pl.placements(mesh, axes), shape)


def _prep_matmul(a: DsArray, b: DsArray, mesh, axes: Axes):
    """Both operands zero-padded (the padded contraction is exact only with
    zero pads; enforced once here, not per schedule step), gk padded to a
    multiple of dn·dm, and placed on the mesh."""
    if a.shape[1] != b.shape[0] or a.block_shape[1] != b.block_shape[0]:
        raise ValueError("distributed matmul requires matching inner grid/block dims")
    dn, dm = _sizes(mesh, axes)
    gk = round_up(max(a.stacked_grid[1], b.stacked_grid[0]), dn * dm)
    a = a.ensure_zero_pad()._pad_grid_to((a.stacked_grid[0], gk))
    b = b.ensure_zero_pad()._pad_grid_to((gk, b.stacked_grid[1]))
    return a.distribute(mesh, axes), b.distribute(mesh, axes)


def _out_grid(a: DsArray, b: DsArray) -> BlockGrid:
    return BlockGrid((a.shape[0], b.shape[1]), (a.block_shape[0], b.block_shape[1]))


def _summa_panels(a_loc: torch.Tensor, b_loc: torch.Tensor, mesh, axes: Axes):
    """SUMMA's collectives on this rank's shards: the A panel gathered along
    ``axes[1]`` (gi/dn, gk, ., .) and the B panel along ``axes[0]`` (gk,
    gj/dm, ., .)."""
    return (_pl.all_gather(a_loc, mesh, axes[1], 1),
            _pl.all_gather(b_loc, mesh, axes[0], 0))


def _cannon_panels(a_loc: torch.Tensor, b_loc: torch.Tensor, mesh, axes: Axes):
    """Cannon's collectives on this rank's shards: yields the skewed pair of
    panels, then the pair after each of the d - 1 shifts (A one hop left,
    B one hop up)."""
    d = _sizes(mesh, axes)[0]
    r, c = _coords(mesh, axes)
    at = lambda i, j: _rank_at(mesh, axes, i % d, j % d)
    ab = _exchange(a_loc, at(r, c - r), at(r, c + r))
    bb = _exchange(b_loc, at(r - c, c), at(r + c, c))
    yield ab, bb
    for _ in range(d - 1):
        ab = _exchange(ab, at(r, c - 1), at(r, c + 1))
        bb = _exchange(bb, at(r - 1, c), at(r + 1, c))
        yield ab, bb


def summa_matmul(a: DsArray, b: DsArray, mesh, axes: Axes = ("data", "model"),
                 gemm: Optional[Callable] = None) -> DsArray:
    """C = A @ B with an explicit SUMMA (gather-form) schedule; C is placed
    ``(axes[0], axes[1])`` on the mesh."""
    a, b = _prep_matmul(a, b, mesh, axes)
    out = _local_gemm(*_summa_panels(_pl.local(a.blocks), _pl.local(b.blocks),
                                     mesh, axes), gemm)
    shape = (a.stacked_grid[0], b.stacked_grid[1]) + tuple(out.shape[2:])
    return DsArray(_result(out, mesh, axes, shape), _out_grid(a, b))


def cannon_matmul(a: DsArray, b: DsArray, mesh, axes: Axes = ("data", "model"),
                  gemm: Optional[Callable] = None) -> DsArray:
    """Cannon's algorithm on a square (d x d) mesh slice: every rank skews
    its panels once, then shifts its A panel one hop left and its B panel
    one hop up d − 1 times, a local GEMM after each; only nearest-neighbour
    traffic in the steady state."""
    dn, dm = _sizes(mesh, axes)
    if dn != dm:
        raise ValueError("cannon_matmul requires a square mesh slice")
    a, b = _prep_matmul(a, b, mesh, axes)
    acc = None
    for ab, bb in _cannon_panels(_pl.local(a.blocks), _pl.local(b.blocks), mesh, axes):
        part = _local_gemm(ab, bb, gemm)
        acc = part if acc is None else acc + part
    shape = (a.stacked_grid[0], b.stacked_grid[1]) + tuple(acc.shape[2:])
    return DsArray(_result(acc, mesh, axes, shape), _out_grid(a, b))


def matmul_ta_psum(a: DsArray, b: DsArray, mesh, axes: Axes = ("data", "model")
                   ) -> DsArray:
    """C = Aᵀ @ B for A and B placed alike, rows over ``axes[0]`` and
    columns over ``axes[1]`` (either may be ``None``): each rank gathers its
    block rows of A and of B along ``axes[1]``, contracts them with the
    transpose read through strides (one ``local_matmul``, so one
    ``stacked_matmul`` launch on the card), and the partial products are
    all-reduced over ``axes[0]`` (paper Fig. 5's reduction, over the sample
    blocks).  Neither operand is gathered whole; every rank holds C, whose
    blocks are then placed ``(axes[0], axes[1])``."""
    from repro_torch.kernels.matmul.ops import local_matmul
    if a.shape[0] != b.shape[0] or a.block_shape[0] != b.block_shape[0]:
        raise ValueError("matmul_ta_psum requires matching row grids")
    a = a.distribute(mesh, axes).ensure_zero_pad()
    b = b.distribute(mesh, axes).ensure_zero_pad()
    if a.stacked_grid[0] != b.stacked_grid[0]:
        gk = max(a.stacked_grid[0], b.stacked_grid[0])
        a = a._pad_grid_to((gk, a.stacked_grid[1]))
        b = b._pad_grid_to((gk, b.stacked_grid[1]))
    ap = _pl.gather_dim(_pl.local(a.blocks), a.blocks, 1)
    bp = _pl.gather_dim(_pl.local(b.blocks), b.blocks, 1)
    part = local_matmul(ap, bp, out_dtype=torch.promote_types(a.dtype, b.dtype),
                        transpose_a=True)
    part = _pl.reduce_shards(part.contiguous(), a.blocks, (0,), "sum")
    out = DsArray(part, BlockGrid((a.shape[1], b.shape[1]),
                                  (a.block_shape[1], b.block_shape[1])))
    return out.distribute(mesh, axes)


def transpose_pp(a: DsArray, mesh, axes: Axes = ("data", "model")) -> DsArray:
    """Transpose = local block transpose + ONE mirrored exchange (square
    mesh): rank (r, c) transposes its shard and sends it to rank (c, r), so
    every byte crosses the mesh once.  The result is placed ``(axes[0],
    axes[1])``, unlike ``DsArray.transpose``'s mirrored placement."""
    dn, dm = _sizes(mesh, axes)
    if dn != dm:
        raise ValueError("transpose_pp requires a square mesh slice; use "
                         "DsArray.transpose() otherwise")
    a = a.distribute(mesh, axes)
    r, c = _coords(mesh, axes)
    peer = _rank_at(mesh, axes, c, r)
    xt = _exchange(_pl.local(a.blocks).permute(1, 0, 3, 2).contiguous(), peer, peer)
    gn, gm, bn, bm = a.blocks.shape
    # pure permutation: the pad region maps onto the transposed pad region,
    # so the operand's pad state (and constant) carries over
    return DsArray(_result(xt, mesh, axes, (gm, gn, bm, bn)), a.grid.transpose(),
                   a.pad_state)


def colsum_psum(a: DsArray, mesh, axes: Axes = ("data", "model")) -> DsArray:
    """Paper Fig. 5 column-of-blocks summation with an explicit all-reduce
    over the ``axes[0]`` mesh dim (one partial sum per rank, one
    reduction); the result is replicated on ``axes[0]`` and sharded on
    ``axes[1]``."""
    a = a.distribute(mesh, axes).ensure_zero_pad()
    x = _pl.local(a.blocks)                         # (gn/dn, gm/dm, bn, bm)
    partial = x.sum(dim=(0, 2), dtype=torch.int32 if not x.dtype.is_floating_point
                    else None)                       # (gm/dm, bm)
    _pl.reduce_shards(partial, a.blocks, (0,), "sum")
    gm, bm = a.stacked_grid[1], a.block_shape[1]
    places = _pl.reduced(a.blocks.placements, (0,))
    blocks = _pl.wrap(partial[None, :, None, :], mesh, places, (1, gm, 1, bm))
    return DsArray(blocks, BlockGrid((1, a.shape[1]), (1, bm)))


# ---------------------------------------------------------------------------
# Placement-keeping structural ops: the operand is placed on the mesh (its
# grid padded to mesh multiples), the block-native op runs, and the result
# carries the same placement (the SPMD analogue of the paper's "slicing
# returns a ds-array with the same worker placement").
# ---------------------------------------------------------------------------


def _redistribute(out: DsArray, mesh, axes: Axes) -> DsArray:
    """``out`` with its grid padded to mesh multiples, placed ``(axes[0],
    axes[1])`` on the mesh."""
    return out.distribute(mesh, axes)


def slice_sharded(a: DsArray, key, mesh, axes: Axes = ("data", "model")) -> DsArray:
    """``A[key]`` on a mesh: block-native selection, result re-placed."""
    a = a.distribute(mesh, axes)
    return _redistribute(structural.getitem(a, key), mesh, axes)


def rechunk_sharded(a: DsArray, block_shape: Tuple[int, int], mesh,
                    axes: Axes = ("data", "model")) -> DsArray:
    """Re-block on a mesh: grid-local regroup, result re-placed."""
    a = a.distribute(mesh, axes)
    return _redistribute(structural.rechunk(a, block_shape), mesh, axes)


def concat_rows_sharded(arrays, mesh, axes: Axes = ("data", "model")) -> DsArray:
    """Vertical concat on a mesh: grid stack, result re-placed."""
    arrays = [a.distribute(mesh, axes) for a in arrays]
    return _redistribute(structural.concat_rows(arrays), mesh, axes)
