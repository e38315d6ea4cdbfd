"""The fault-injection hook of the instrumented sites (plan execution, GEMM
dispatch, loaders, checkpoints, fit loops).

:func:`fire` consults ``repro_torch.resilience.inject`` only when that
module is already imported (a chaos test armed it); a clean run pays one
``sys.modules`` lookup.  This module imports nothing of the package, so
every layer can import it.
"""

from __future__ import annotations

import sys


def fire(site: str, **info) -> None:
    """Raise the armed fault of ``site``, if any (``inject.maybe_fire``)."""
    ri = sys.modules.get("repro_torch.resilience.inject")
    if ri is not None:
        ri.maybe_fire(site, **info)
