"""The ds-array core of the port: geometry, the DsArray type, creation
routines, the block-native structural ops and shuffles, and the lazy plan
layer (``expr`` records, ``plan`` optimizes, caches and runs)."""

from repro_torch.core.blocking import BlockGrid
from repro_torch.core.dsarray import (PAD_DIRTY, PAD_ZERO, DsArray, PadState,
                                      apply_along_axis, concat_rows, eye,
                                      from_array, full, identity_like,
                                      matmul_ta, pad_state_of, random_array,
                                      zeros)
from repro_torch.core import structural
from repro_torch.core.shuffle import exact_shuffle, pseudo_shuffle
from repro_torch.core import expr, plan
from repro_torch.core.expr import LazyDsArray, lazy
from repro_torch.core.plan import compute, compute_multi
from repro_torch.core.structural import gram, take_cols, take_rows

__all__ = ["BlockGrid", "DsArray", "PadState", "PAD_ZERO", "PAD_DIRTY",
           "pad_state_of", "from_array", "zeros", "full", "eye",
           "identity_like", "random_array", "concat_rows", "apply_along_axis",
           "pseudo_shuffle", "exact_shuffle", "structural", "gram",
           "take_rows", "take_cols", "matmul_ta", "expr", "plan",
           "LazyDsArray", "lazy", "compute", "compute_multi"]
