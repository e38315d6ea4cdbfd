"""The ds-array core of the port: geometry, the DsArray type, creation
routines, sparse blocks (``sparse``: the stacked COO, ``from_scipy``,
``random_sparse``), the cost-model laws (``costmodel``), the block-native
structural ops and shuffles, the lazy plan layer (``expr`` records,
``plan`` optimizes, caches and runs), ingestion and spill formats
(``io``, over the byte-range ``readers``), the paper's row-partitioned
Dataset baseline (``dataset_baseline``, host NumPy), and distribution:
``compat.make_mesh`` builds a ``DeviceMesh``, ``DsArray.distribute`` places
the blocks on it, and ``shmap_ops`` (imported as a module) holds the
explicitly scheduled SUMMA, Cannon, transpose and column-sum collectives."""

from repro_torch.core.blocking import BlockGrid
from repro_torch.core.dataset_baseline import Dataset, Subset, TaskCounter
from repro_torch.core.dsarray import (PAD_DIRTY, PAD_ZERO, DsArray, PadState,
                                      apply_along_axis, concat_rows, eye,
                                      from_array, full, identity_like,
                                      matmul_ta, pad_state_of, random_array,
                                      zeros)
from repro_torch.core import compat, costmodel, sparse, structural
from repro_torch.core.sparse import StackedCOO, from_scipy, random_sparse
from repro_torch.core.shuffle import exact_shuffle, pseudo_shuffle
from repro_torch.core import expr, plan
from repro_torch.core.expr import LazyDsArray, lazy
from repro_torch.core.plan import compute, compute_multi
from repro_torch.core.structural import gram, take_cols, take_rows
from repro_torch.core import io, readers

__all__ = ["BlockGrid", "Dataset", "Subset", "TaskCounter", "DsArray",
           "PadState", "PAD_ZERO", "PAD_DIRTY", "pad_state_of", "from_array",
           "zeros", "full", "eye", "identity_like", "random_array",
           "concat_rows", "apply_along_axis", "pseudo_shuffle",
           "exact_shuffle", "structural", "gram", "take_rows", "take_cols",
           "matmul_ta", "costmodel", "sparse", "StackedCOO", "from_scipy",
           "random_sparse", "expr", "plan", "LazyDsArray", "lazy", "compute",
           "compute_multi", "io", "readers", "compat"]
