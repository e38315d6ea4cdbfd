"""Production mesh definitions, the port of ``repro.launch.mesh``.

Single pod: (32, 8) = ("data", "model"), 256 H100s (32 nodes of 8).
Multi-pod:  (2, 32, 8) = ("pod", "data", "model"), 512 H100s (64 nodes).

The reference's mesh is a TPU v5e pod, (16, 16): its 16-chip ``model`` axis
is one ICI ring.  On H100s the fast domain is one node's NVLink switch,
8 GPUs, so the ``model`` axis (tensor parallelism, whose collectives run
every layer) is 8 ranks within a node and ``data`` spans the 32 nodes
(InfiniBand), with the same 256 and 512 ranks in all.

Functions, not module constants: importing this module touches no process
group.  Every mesh stands on the caller's initialised default group
(``core.compat.make_mesh``): NCCL under ``torchrun`` on a real job, or
the ``fake`` group of :func:`fake_process_group`, on which the dry run
(``launch.dryrun``) builds the same mesh in one process with no card.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence, Tuple

from repro_torch.core.compat import AxisType, make_mesh

SINGLE_POD = ((32, 8), ("data", "model"))
MULTI_POD = ((2, 32, 8), ("pod", "data", "model"))


def _device_type() -> str:
    """The mesh device of the default group: ``"cpu"`` on gloo, else
    ``"cuda"`` (NCCL, or the fake group that stands in for it)."""
    import torch.distributed as dist
    if dist.is_initialized() and str(dist.get_backend()) == "gloo":
        return "cpu"
    return "cuda"


def make_production_mesh(*, multi_pod: bool = False):
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, axes, device_type="cuda",
                     axis_types=(AxisType.Auto,) * len(axes))


def dp_axes(multi_pod: bool = False) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def make_host_mesh(shape: Optional[Sequence[int]] = None, axes=None):
    """A mesh over every rank of the default group (tests, examples, the
    dry run's parity with the reference's (16, 16) layouts): ``(1, n)``
    ``("data", "model")`` by default."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape, axes = ((1, n) if n > 1 else (1, 1)), ("data", "model")
    if math.prod(shape) != n:
        raise ValueError(f"mesh {tuple(shape)} holds {math.prod(shape)} "
                         f"ranks; the process group has {n}")
    return make_mesh(tuple(shape), tuple(axes), device_type=_device_type(),
                     axis_types=(AxisType.Auto,) * len(shape))


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """torch's ``fake`` process group of ``world_size`` ranks, this process
    being rank 0, for the duration of the block: collectives return at
    once and move nothing, so one process can place ``meta`` tensors on a
    mesh of any size and see rank 0's shards.  Refuses to replace a group
    already initialised; destroys its own on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the fake "
                           "group needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
