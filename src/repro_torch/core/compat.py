"""Mesh construction for the distributed ds-array (the port of
``repro.core.compat``).

The reference's compat module smooths three jax API moves: ``AxisType``,
``jax.make_mesh(..., axis_types=...)`` and ``shard_map``'s
``check_vma``/``check_rep`` flag, plus ``pltpu.CompilerParams``' rename
(``tpu_compiler_params``).  Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, and the
shard bodies of ``core.shmap_ops`` are plain functions of the local shards
with explicit collectives, so ``shard_map`` and ``tpu_compiler_params``
have no counterpart: there is no jax version to bridge and no Pallas
compiler to configure.  ``AxisType`` stays as a stand-in so that callers
can pass ``axis_types=(AxisType.Auto,) * n`` as they do to the reference.

The reference takes its devices from the jax runtime, one controller for
all of them.  The port is SPMD: every rank runs the same program, and the
process group is the caller's (``torchrun``, or
``torch.distributed.init_process_group`` with an explicit store and rank).
:func:`make_mesh` never creates one, and no environment variable picks the
device or the backend: NCCL backs a ``"cuda"`` mesh, gloo a ``"cpu"`` one.
A ``"cuda"`` mesh may also stand on torch's ``fake`` process group, which
moves nothing: the dry run (``launch.dryrun``) builds the production mesh
of 256 or 512 ranks on it in one process, with every tensor on ``meta``.
"""

from __future__ import annotations

import enum
import math
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["AxisType", "make_mesh"]


class AxisType(enum.Enum):
    """Stand-in for ``jax.sharding.AxisType``; every mesh here is Auto."""

    Auto = "auto"
    Explicit = "explicit"
    Manual = "manual"


_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device_type: str = "cuda",
              axis_types: Optional[Tuple] = None):
    """A ``DeviceMesh`` of shape ``axis_shapes`` with dims ``axis_names``
    over ranks ``0 .. prod(axis_shapes) - 1`` of the initialised default
    process group, row-major (the layout ``jax.make_mesh`` gives).  The
    mesh covers the whole group.  ``axis_types`` is checked and ignored."""
    import torch.distributed as dist
    shape, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"{len(shape)} axis shapes for {len(names)} names")
    if axis_types is not None and len(tuple(axis_types)) != len(names):
        raise ValueError(f"{len(tuple(axis_types))} axis types for "
                         f"{len(names)} axes")
    if device_type not in _BACKEND:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised process group: start the ranks "
            "with torchrun, or call torch.distributed.init_process_group("
            f"{_BACKEND[device_type]!r}, store=..., rank=..., world_size=...) "
            "in every rank first")
    backend = str(dist.get_backend())
    if _BACKEND[device_type] not in backend and not (
            device_type == "cuda" and backend == "fake"):
        raise ValueError(f"a {device_type!r} mesh needs the "
                         f"{_BACKEND[device_type]} backend; the process "
                         f"group runs {backend}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} holds {math.prod(shape)} ranks; the "
                         f"process group has {world}")
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=names)
    # every rank meets once on the whole group, so that its NCCL
    # communicator exists before a schedule's first point-to-point batch
    # (NCCL's rule: the first call on a group needs every rank of it)
    dist.barrier()
    return mesh
