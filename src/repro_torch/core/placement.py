"""Stacked blocks placed on a device mesh: the port's counterpart of the
reference's ``NamedSharding(mesh, P(axes[0], axes[1], None, None))``.

A distributed ds-array holds its stacked blocks as a ``DTensor`` over a
``DeviceMesh`` (``core.compat.make_mesh``): grid dim 0 is ``Shard(0)`` on the
mesh dim named ``axes[0]``, grid dim 1 is ``Shard(1)`` on the one named
``axes[1]``, and every other mesh dim (or an axis given as ``None``) is
``Replicate()``.  Each rank holds its shard as the DTensor's local tensor.
The functions here read and write those shards directly, with every
collective explicit; the ops do not lean on DTensor's op propagation, which
drops a sliced sharded dim to ``Replicate`` and refuses a plain tensor
beside a DTensor.

A dim of ``size`` sharded over ``d`` ranks is cut as ``torch.chunk`` cuts
it: ``ceil(size / d)`` per rank, the last ones shorter or empty.  The ops
pad grids to mesh multiples, so shards are even but where a caller asks
for an exact grid (``DsArray._pad_grid_to``).

A DTensor whose local shard is a ``meta`` tensor stands for a placed array
in the lazy layer's metadata inference (``core.expr``): every collective
here and in ``core.shmap_ops`` returns its result's shape on such a shard
and moves nothing, so an op's recorded metadata is its eager run's.

``torch.distributed.tensor`` is imported only when a mesh is first used, so
that ``import repro_torch`` does not pay for it.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, Tuple

import torch

Axes = Tuple[Optional[str], Optional[str]]


def is_dtensor(t) -> bool:
    """True for a ``DTensor`` (none can exist before its module is loaded)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def abstract(t):
    """A DTensor of ``t``'s mesh, placements and shape over a ``meta``
    shard (the lazy layer's metadata stand-in for a placed tensor)."""
    loc = local(t)
    return wrap(torch.empty(tuple(loc.shape), dtype=loc.dtype, device="meta"),
                t.device_mesh, t.placements, t.shape)


def signature(t) -> tuple:
    """Hashable identity of a tensor's placement: ``()`` for a plain
    tensor, else its mesh and placements."""
    return (t.device_mesh, tuple(t.placements)) if is_dtensor(t) else ()


def axis_size(mesh, axis: Optional[str]) -> int:
    """The size of the mesh dim named ``axis`` (1 for ``None``)."""
    if axis is None:
        return 1
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r}; its axes are {names}")
    return mesh.size(names.index(axis))


def placements(mesh, axes: Axes) -> tuple:
    """The DTensor placements, one per mesh dim, of blocks whose grid dims
    are sharded over the mesh axes ``axes``."""
    from torch.distributed.tensor import Replicate, Shard
    if len(axes) != 2:
        raise ValueError(f"axes names the two grid dims, got {axes}")
    for a in axes:
        axis_size(mesh, a)
    if axes[0] is not None and axes[0] == axes[1]:
        raise ValueError(f"both grid dims on mesh axis {axes[0]!r}")
    return tuple(Shard(axes.index(n)) if n in axes else Replicate()
                 for n in mesh.mesh_dim_names)


def spec_placements(mesh, spec: Sequence) -> tuple:
    """The DTensor placements, one per mesh dim, of a tensor laid out by
    ``spec`` (``distributed.sharding.Spec``: per tensor dim ``None``, a mesh
    axis name or a tuple of them): a mesh dim named at tensor dim ``d`` is
    ``Shard(d)``, every other mesh dim ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    dims = {}
    for d, names in enumerate(spec):
        for name in ((names,) if isinstance(names, str) else names or ()):
            axis_size(mesh, name)
            if name in dims:
                raise ValueError(f"mesh axis {name!r} shards two dims of {spec}")
            dims[name] = d
    return tuple(Shard(dims[n]) if n in dims else Replicate()
                 for n in mesh.mesh_dim_names)


def axes_of(t) -> Tuple[object, Axes]:
    """The mesh of a placed block tensor and the mesh axes of its grid dims
    (the inverse of :func:`placements`)."""
    names = t.device_mesh.mesh_dim_names
    axes = [None, None]
    for name, p in zip(names, t.placements):
        if p.is_replicate():
            continue
        if not p.is_shard() or p.dim not in (0, 1) or axes[p.dim] is not None:
            raise NotImplementedError(
                f"blocks placed as {tuple(t.placements)}: only the grid dims "
                f"may be sharded, each on one mesh axis")
        axes[p.dim] = name
    return t.device_mesh, tuple(axes)


def mirrored(places: Sequence) -> tuple:
    """``places`` with grid dims 0 and 1 swapped (the transpose's)."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(1 - p.dim) if p.is_shard() else p for p in places)


def reduced(places: Sequence, dims: Sequence[int]) -> tuple:
    """``places`` with the mesh dims that shard one of ``dims`` replicated
    (the placement of a result summed over those dims)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_shard() and p.dim in dims else p
                 for p in places)


def _chunk(size: int, parts: int, index: int) -> slice:
    step = -(-size // parts) if size else 0
    start = min(index * step, size)
    return slice(start, min(start + step, size))


def shard_slices(mesh, places: Sequence, shape: Sequence[int]) -> tuple:
    """The slices of a tensor of ``shape`` that this rank holds."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    out = [slice(0, int(n)) for n in shape]
    for i, p in enumerate(places):
        if p.is_shard():
            # a dim sharded over several mesh dims is cut by each in mesh
            # order, each cutting the piece the one before left
            cur = out[p.dim]
            sub = _chunk(cur.stop - cur.start, mesh.size(i), coord[i])
            out[p.dim] = slice(cur.start + sub.start, cur.start + sub.stop)
    return tuple(out)


def offsets(t) -> Tuple[int, int]:
    """The grid coordinates of the first block of this rank's shard."""
    sl = shard_slices(t.device_mesh, t.placements, t.shape)
    return sl[0].start or 0, sl[1].start or 0


def local(t):
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def _stride(loc: torch.Tensor, shape: Sequence[int]) -> tuple:
    """Packed strides of ``shape`` in the dim order of ``loc``'s layout."""
    order = sorted(range(len(shape)), key=lambda d: (-loc.stride(d), d))
    out, acc = [0] * len(shape), 1
    for d in reversed(order):
        out[d] = acc
        acc *= int(shape[d])
    return tuple(out)


def wrap(loc: torch.Tensor, mesh, places: Sequence, shape: Sequence[int]):
    """This rank's shard ``loc`` as the DTensor of global ``shape`` (no
    communication)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(loc, mesh, tuple(places), run_check=False,
                              shape=torch.Size(shape), stride=_stride(loc, shape))


def rewrap(loc: torch.Tensor, like):
    """``loc`` as a DTensor with ``like``'s mesh, placements and shape."""
    return wrap(loc, like.device_mesh, like.placements, like.shape)


def place(full: torch.Tensor, mesh, places: Sequence):
    """Place ``full``, which every rank holds alike (SPMD), on the mesh: each
    rank keeps its own shard, a view of ``full`` (no communication)."""
    if full.device.type not in (mesh.device_type, "meta"):
        raise ValueError(f"blocks on {full.device} cannot be placed on a "
                         f"{mesh.device_type!r} mesh")
    loc = full[shard_slices(mesh, places, full.shape)]
    return wrap(loc, mesh, places, full.shape)


def gather(t):
    """The whole tensor on every rank (an all-gather of the shards)."""
    if not is_dtensor(t):
        return t
    if t.to_local().device.type == "meta":      # metadata inference
        return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
    return t.full_tensor()


def all_gather(loc: torch.Tensor, mesh, mesh_dim, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(loc, axis, axis=dim, tiled=True)``: the shards of
    the ranks along the mesh dim ``mesh_dim`` (its index or name),
    concatenated on ``dim`` in mesh order."""
    import torch.distributed as dist
    group = mesh.get_group(mesh_dim)
    n = dist.get_world_size(group)
    if loc.device.type == "meta":          # metadata inference: shapes only
        return torch.cat([loc] * n, dim=dim)
    loc = loc.contiguous()
    parts = [torch.empty_like(loc) for _ in range(n)]
    dist.all_gather(parts, loc, group=group)
    return torch.cat(parts, dim=dim)


def gather_dim(loc: torch.Tensor, like, dim: int) -> torch.Tensor:
    """This rank's partial ``loc`` with tensor dim ``dim`` made whole: an
    :func:`all_gather` over the mesh dim that shards dim ``dim`` of ``like``
    (``loc`` as it is when none does)."""
    for i, p in enumerate(like.placements):
        if p.is_shard() and p.dim == dim:
            return all_gather(loc, like.device_mesh, i, dim)
    return loc


def reduce_shards(loc: torch.Tensor, like, dims: Sequence[int], op: str):
    """All-reduce this rank's partial ``loc`` (in place) over every mesh dim
    that shards one of the tensor dims ``dims`` of ``like``; ``op`` is
    ``"sum"``, ``"max"`` or ``"min"``."""
    import torch.distributed as dist
    if loc.device.type == "meta":
        return loc
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    mesh = like.device_mesh
    for i, p in enumerate(like.placements):
        if p.is_shard() and p.dim in dims:
            dist.all_reduce(loc, op=rop, group=mesh.get_group(i))
    return loc
