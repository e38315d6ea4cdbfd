"""Public K-means assignment entry points.

A CUDA tensor launches the CUDA kernel (``kernel.kmeans_assign_stacked``);
a CPU tensor takes the plain version (``ref``).  The port returns counts as
``(k,)`` and needs no far-away pad centers: the kernel masks the edges.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.kmeans import kernel
from repro_torch.kernels.kmeans.ref import (kmeans_assign_ref,
                                            kmeans_assign_stacked_ref)

__all__ = ["kmeans_assign", "kmeans_assign_stacked", "kmeans_assign_ref",
           "kmeans_assign_stacked_ref"]

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def kmeans_assign_stacked(blocks: torch.Tensor, centers: torch.Tensor,
                          n: int) -> Stats:
    """labels ``(gn*bn,)`` int32 (-1 for rows >= n), sums ``(k, gm*bm)``
    f32, counts ``(k,)`` f32 for the stacked ``(gn, gm, bn, bm)`` tensor."""
    if blocks.device.type == "cpu":
        return kmeans_assign_stacked_ref(blocks, centers, n)
    if blocks.device.type != "cuda":
        raise ValueError(f"no kmeans_assign for device {blocks.device}")
    return kernel.kmeans_assign_stacked(blocks, centers, n)


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor) -> Stats:
    """The reference's 2-D form: labels ``(n,)`` int32, sums ``(k, d)`` f32,
    counts ``(k,)`` f32 for samples ``x (n, d)``."""
    n, d = x.shape
    labels, sums, counts = kmeans_assign_stacked(
        x.reshape(1, 1, n, d).contiguous(),
        centers.to(x.dtype).contiguous(), n)
    return labels[:n], sums, counts
