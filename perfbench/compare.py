"""The numbers a run is judged by, worked out from the program's readings and
the reference's.  Each is a gap that 0 means no difference at all; its
limit is in ``limits/<cell>.json``."""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

#: a leaf whose reference gradient is under this share of the median leaf's
#: moves by round-off alone (a key's bias under softmax): it is left out
QUIET_LEAF = 1e-3
SLICE = 1 << 26


def leaf_norm(t: torch.Tensor, scale: float = 1.0) -> float:
    """The float32 norm of ``t`` (times ``scale``), a slice at a time."""
    flat = t.reshape(-1)
    total = 0.0
    for lo in range(0, flat.numel(), SLICE):
        part = flat[lo:lo + SLICE].float()
        total += float(torch.sum(part * part))
    return total ** 0.5 * scale


def diff_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """The float32 norm of ``a - b``, a slice at a time."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    total = 0.0
    for lo in range(0, fa.numel(), SLICE):
        d = fa[lo:lo + SLICE].float() - fb[lo:lo + SLICE].float()
        total += float(torch.sum(d * d))
    return total ** 0.5


def rel_gap(got: List[float], want: List[float]) -> float:
    """The widest relative gap of a list of scalars."""
    if len(got) != len(want):
        return float("inf")
    return max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))


def leaf_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    """The worst leaf's gap between two per-leaf norms, over the reference's
    norm of that leaf or of the median leaf, whichever is larger; leaves
    whose reference gradient is under ``QUIET_LEAF`` of the median leaf's
    are left out by the caller (``quiet_leaves``)."""
    med = statistics.median(want.values())
    return max(abs(got.get(k, 0.0) - w) / max(w, med, 1e-30) for k, w in want.items())


def quiet_leaves(grad_norms: Dict[str, float]) -> List[str]:
    med = statistics.median(grad_norms.values())
    return sorted(k for k, v in grad_norms.items() if v < QUIET_LEAF * med)


def train_gaps(prog: dict, ref: dict, side: str = "program") -> Dict[str, float]:
    """The training cell's numbers: the widest relative gap of a step's loss
    and of a step's gradient norm (before clipping); the worst leaf's gap of
    the first gradient as the optimizer gets it and of the parameters'
    change over the steps followed; and ``param_gap``, the worst leaf's
    distance between the two sides' weights after those steps (the
    reference's ``param_leaf[side]``), against the reference's change of
    that leaf or of the median leaf, whichever is larger: a change of the
    right size in the wrong direction reads there."""
    quiet = set(quiet_leaves(ref["grad_leaf"]))
    keep = lambda d: {k: v for k, v in d.items() if k not in quiet}  # noqa: E731
    change = keep(ref["delta_leaf"])
    med = statistics.median(change.values())
    dist = ref["param_leaf"][side]
    return {
        "loss_gap": rel_gap(prog["loss"], ref["loss"]),
        "grad_norm_gap": rel_gap(prog["grad_norm"], ref["grad_norm"]),
        "grad_leaf_gap": leaf_gap(keep(prog["grad_leaf"]), keep(ref["grad_leaf"])),
        "delta_leaf_gap": leaf_gap(keep(prog["delta_leaf"]), change),
        "param_gap": max(dist[k] / max(w, med, 1e-30) for k, w in change.items()),
    }
