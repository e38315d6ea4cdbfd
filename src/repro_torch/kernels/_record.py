"""The hook through which a graph recorder sees a kernel wrapper's call.

``analysis.graphs.trace_ops`` records the aten ops of one run.  A kernel
wrapper hands its launch (on the card) or its plain version (on the CPU) to
:func:`kernel`, so that an active recorder keeps the call as ONE node,
``kernel:<name>`` with the call's outputs, and hides whatever ops the call
dispatches inside: the graph of a run is then the same on both devices.
:func:`scoped` tags the ops of a helper whose selects are its own work and
no mask passes (``core.dsarray._cast``'s saturation,
``ops.sparse_contract``'s index selects): the tag is the one place that
decides it, and ``analysis.graphs.count_selects`` skips every tagged op.
:func:`step` tags the ops of one step of a fused Blockwise's composed body
(``core.plan._compose``), so that the analysis can tell a step's own output
from an intermediate inside it.

With no recorder active each costs one read of a context variable; the
call itself, its route, its counters and its errors are the wrapper's own.
"""

from __future__ import annotations

import contextvars

# the recorder of the running trace_ops, or None
ACTIVE = contextvars.ContextVar("repro_torch_graph_recorder", default=None)


def kernel(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, seen by an active recorder as one node."""
    rec = ACTIVE.get()
    if rec is None:
        return fn(*args, **kwargs)
    return rec.opaque(name, fn, args, kwargs)


def scoped(scope: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its ops tagged ``scope`` by an active
    recorder: their selects are ``fn``'s own work, no mask passes."""
    rec = ACTIVE.get()
    if rec is None:
        return fn(*args, **kwargs)
    return rec.scoped(scope, fn, args, kwargs)


def step(fn, *args):
    """``fn(*args)``, its ops tagged by an active recorder with a step
    number of their own (the innermost step wins)."""
    rec = ACTIVE.get()
    if rec is None:
        return fn(*args)
    return rec.step(fn, args)
