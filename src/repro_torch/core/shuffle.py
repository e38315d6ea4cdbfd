"""Row shuffles for ds-arrays (paper §5.4), the port of
``repro.core.shuffle``.

* ``pseudo_shuffle`` — the paper's two stages: permute the block-rows, then
  permute the rows inside every block-row.  Not a uniform permutation, but
  every row keeps exactly one copy.  Ragged row counts (the last block-row
  part pad) take ``exact_shuffle``.
* ``exact_shuffle`` — one uniform permutation of the rows, applied as one
  per-block row gather (``structural.take_rows``); the output pad is ZERO.

Randomness comes from an explicit ``torch.Generator`` on the array's
device.  Both shuffles draw their permutation first and then apply it as
one gather of source rows, so a lazy recording draws it when the op is
recorded and the plan takes it as an input (``core.expr.record_shuffle``):
the same generator state gives the same rows, eager or lazy.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.dsarray import DsArray, _lazy_mode


def source_rows(generator: torch.Generator, kind: str, shape: Tuple[int, int],
                block_shape: Tuple[int, int], stacked_rows: int,
                device: torch.device) -> Tuple[str, torch.Tensor]:
    """``(kind, src)``: the shuffle that runs (a ragged ``"pseudo"`` becomes
    ``"exact"``) and the source row of every output row, drawn from
    ``generator``, which must be on the array's ``device``.

    ``"pseudo"``: ``stacked_rows`` block-rows permuted, then the rows of
    each block-row (one argsort of uniform float64 draws per block-row);
    ``"exact"``: one uniform permutation of the ``n`` rows."""
    n, bn = shape[0], block_shape[0]
    dev = generator.device
    if (dev.type, dev.index or 0) != (device.type, device.index or 0):
        raise ValueError(f"the generator is on {dev}, the array on {device}")
    if kind == "pseudo" and n > 0 and n % bn == 0:
        block_perm = torch.randperm(stacked_rows, generator=generator, device=dev)
        keys = torch.rand((stacked_rows, bn), generator=generator, device=dev,
                          dtype=torch.float64)
        src = block_perm[:, None] * bn + torch.argsort(keys, dim=1)
        return "pseudo", src.reshape(-1)
    return "exact", torch.randperm(n, generator=generator, device=dev)


def apply_rows(a: DsArray, kind: str, src: torch.Tensor) -> DsArray:
    """``a`` with its rows gathered from ``src`` (from :func:`source_rows`)."""
    from repro_torch.core import structural
    if kind == "pseudo":
        # rows tile the block-rows evenly, so the pad columns are permuted
        # among themselves and the pad state carries over
        bn = a.block_shape[0]
        return DsArray(structural._gather_block_rows(a.blocks, src, bn),
                       a.grid, a.pad_state)
    return structural.take_rows(a, src, out_bn=a.block_shape[0], checked=True)


def _shuffle(generator: torch.Generator, a, kind: str):
    from repro_torch.core import expr
    if isinstance(a, expr.LazyDsArray) or _lazy_mode():
        return expr.record_shuffle(generator, a, kind)
    kind, src = source_rows(generator, kind, a.shape, a.block_shape,
                            a.stacked_grid[0], a.device)
    return apply_rows(a, kind, src)


def pseudo_shuffle(generator: torch.Generator, a: DsArray) -> DsArray:
    """The paper's two-stage pseudo shuffle: block-rows permuted, then the
    rows within each block-row.  Records a plan node when ``a`` is lazy or
    recording is armed."""
    return _shuffle(generator, a, "pseudo")


def exact_shuffle(generator: torch.Generator, a: DsArray) -> DsArray:
    """A uniform random permutation of the rows, block-native (one per-block
    row gather, no ``collect()``), output pad ZERO.  Records a plan node
    when ``a`` is lazy or recording is armed."""
    return _shuffle(generator, a, "exact")
