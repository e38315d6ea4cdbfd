"""Plain PyTorch versions of the fused K-means assignment: the CPU path of
``ops.kmeans_assign*`` and what ``chip_smoke.py`` holds the CUDA kernel to."""

from __future__ import annotations

from typing import Tuple

import torch


def kmeans_assign_ref(x: torch.Tensor, centers: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """labels (n,) int32, per-cluster sums (k, d) f32, counts (k,) f32 — the
    port of ``repro.kernels.kmeans.ref.kmeans_assign_ref``."""
    d2 = ((x ** 2).sum(1, keepdim=True)
          - 2.0 * x @ centers.T
          + (centers ** 2).sum(1)[None, :])
    labels = torch.argmin(d2, dim=1)
    onehot = torch.nn.functional.one_hot(labels, centers.shape[0]).float()
    sums = onehot.T @ x.float()
    return labels.to(torch.int32), sums, onehot.sum(0)


def kmeans_assign_stacked_ref(blocks: torch.Tensor, centers: torch.Tensor,
                              n: int
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The assignment step on the stacked ``(gn, gm, bn, bm)`` tensor.

    ``centers`` is ``(k, gm*bm)`` (pad columns zero).  Returns labels
    ``(gn*bn,)`` int32 with -1 on rows >= n, sums ``(k, gm*bm)`` f32 and
    counts ``(k,)`` f32 over the rows < n.
    """
    gn, gm, bn, bm = blocks.shape
    k = centers.shape[0]
    xb = blocks.float()
    c = centers.float().reshape(k, gm, bm)
    dots = torch.einsum("ijab,kjb->iak", xb, c)                 # (gn, bn, k)
    x_sq = (xb * xb).sum(dim=(1, 3))                            # (gn, bn)
    c_sq = (c * c).sum(dim=(1, 2))
    dist = (x_sq[..., None] - 2.0 * dots) + c_sq[None, None, :]
    labels = torch.argmin(dist, dim=-1).reshape(-1)
    valid = torch.arange(gn * bn, device=blocks.device) < n
    labels = torch.where(valid, labels, -1).to(torch.int32)
    onehot = torch.nn.functional.one_hot(labels.clamp(min=0).long(), k).float()
    onehot = onehot * valid[:, None].float()                    # (gn*bn, k)
    sums = torch.einsum("iak,ijab->kjb", onehot.reshape(gn, bn, k), xb)
    return labels, sums.reshape(k, gm * bm), onehot.sum(0)
