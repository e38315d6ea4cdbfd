"""repro_torch — the ds-array reproduction on PyTorch and CUDA.

A second package beside ``repro`` (the JAX reference): the same stacked
``(gn, gm, bn, bm)`` block tensors with ZERO/FILL/DIRTY pad state, dense or
sparse blocks (``core.sparse``: a stacked COO, ``from_scipy``), the
blocked GEMM and K-means, with the TPU kernels of that path rewritten as
CUDA kernels for Hopper (``repro_torch/csrc``).  Creation routines take
``device=`` (default ``"cuda"``); everything downstream runs on the device
of its inputs.  ``repro_torch.lazy()`` (or ``DsArray.lazy()``) records ops
as a plan that ``compute()`` optimizes and runs (``core.expr``,
``core.plan``).  The dislib estimators: ``estimators`` (CascadeSVM, the
linear models, the random forest) and ``algorithms`` (KMeans, ALS, PCA,
TSQR, the Dataset baseline's K-means and ALS), with ``save_model`` /
``load_model`` and per-iteration fit checkpoints (``checkpoint``, the
reference's on-disk format).  Ingestion: ``core.io`` (streaming text,
svmlight and ``.npy`` loaders).  ``resilience``: fault injection,
``run_resilient`` (retry and the fused -> eager -> einsum ladder) and the
block-granular numerical guards.
"""

from repro_torch import core
from repro_torch.core import *  # noqa: F401,F403
from repro_torch import algorithms, estimators
from repro_torch.algorithms import *  # noqa: F401,F403
from repro_torch.estimators import *  # noqa: F401,F403
from repro_torch import checkpoint, resilience

__version__ = "0.1.0"

__all__ = (["core", "algorithms", "estimators", "checkpoint", "resilience",
            "__version__"]
           + list(core.__all__) + list(algorithms.__all__)
           + list(estimators.__all__))
