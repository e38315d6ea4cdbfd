"""repro_torch — the ds-array reproduction on PyTorch and CUDA.

A second package beside ``repro`` (the JAX reference): the same stacked
``(gn, gm, bn, bm)`` block tensors with ZERO/FILL/DIRTY pad state, the
blocked GEMM and K-means, with the TPU kernels of that path rewritten as
CUDA kernels for Hopper (``repro_torch/csrc``).  Creation routines take
``device=`` (default ``"cuda"``); everything downstream runs on the device
of its inputs.
"""

from repro_torch import core
from repro_torch.core import *  # noqa: F401,F403

__version__ = "0.1.0"

__all__ = ["core", "__version__"] + list(core.__all__)
