"""Carry state across from the JAX reference, through NumPy arrays only.

``dsarray_from_numpy`` rebuilds a reference ``DsArray`` from
``np.asarray(x.blocks)``, ``x.shape``, ``x.block_shape`` and ``x.pad_state``;
``kmeans_from_numpy`` rebuilds a fitted reference ``KMeans`` from its
params, centers and iteration count; ``params_from_numpy`` carries a model's
parameter tree.  None imports the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.algorithms.kmeans import KMeans
from repro_torch.core.blocking import BlockGrid
from repro_torch.core.dsarray import (_NARROW, PAD_DIRTY, PAD_ZERO, DsArray,
                                      PadState, resolve_device)


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))   # a writable copy
    return t.to(device=resolve_device(device),
                dtype=_NARROW.get(t.dtype, t.dtype))


def dsarray_from_numpy(blocks: np.ndarray, shape, block_shape, pad_kind: str,
                       pad_fill=None, device="cuda") -> DsArray:
    """A DsArray over the stacked ``(gn, gm, bn, bm)`` ``blocks`` with the
    given geometry and pad state (``pad_kind`` "zero" | "fill" | "dirty")."""
    pad = {"zero": PAD_ZERO, "dirty": PAD_DIRTY}.get(pad_kind)
    if pad is None:
        if pad_kind != "fill":
            raise ValueError(f"unknown pad kind {pad_kind!r}")
        pad = PadState("fill", pad_fill)
    grid = BlockGrid(tuple(shape), tuple(block_shape))
    return DsArray(_tensor(np.asarray(blocks), device), grid, pad)


def kmeans_from_numpy(params: dict, centers: np.ndarray, n_iter: int,
                      device="cuda") -> KMeans:
    """A fitted KMeans from the reference's ``get_params()``, ``centers_``
    and ``n_iter_``."""
    est = KMeans(**params)
    est.centers_ = _tensor(np.asarray(centers), device)
    est.n_iter_ = int(n_iter)
    return est


def params_from_numpy(tree, device="cuda"):
    """A reference parameter tree (nested dicts and lists of NumPy arrays, as
    ``jax.tree_util.tree_map(np.asarray, params)`` gives it) as torch
    tensors on ``device``, with the same dtypes.  bfloat16 arrays (NumPy
    dtype ``bfloat16``, which ``torch.from_numpy`` rejects) are carried bit
    for bit through their 16-bit patterns."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {key: params_from_numpy(v, dev) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr.view(np.uint16)))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr)).to(dev)
