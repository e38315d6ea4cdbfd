"""The benchmark's weights: drawn on the device from the run's seed, laid out
as the port's ``Model`` expects.

The tree (names, shapes, dtypes) is the port's ``Model.init`` on the
``meta`` device, which holds no data.  The values are the benchmark's own:
one flat buffer per dtype, filled with standard normal draws of one seeded
``torch.Generator`` in a few large calls, each leaf a view of its buffer
then scaled in place by the first rule of the configuration's ``init``
list that matches its name.  The same seed gives the same bits, so the
plain reference draws the same weights again rather than taking them from
the program.

A rule is ``[regex, kind, a, b]`` on the dotted leaf name
(``layers.in_proj``, ``groups.0.moe.w_gate``): ``normal`` (mean a, std b),
``fan_in`` (std 1/sqrt(shape[a])), ``uniform``
(from a to b, through the normal's CDF), ``dt_bias`` (Mamba's time-step
bias: softplus⁻¹ of a step log-uniform from a to b).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 28                      # elements per draw


def leaf_names(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted name, leaf) of a tree of dicts and lists, in the port's order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaf_names(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def rebuild(tree, values: Dict[str, torch.Tensor], prefix: str = ""):
    """``tree`` with each leaf replaced by ``values[name]``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, values, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, values, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return values[prefix[:-1]]


def meta_tree(model):
    return model.init(torch.Generator(), "meta")


def rule_for(rules, name: str):
    for r in rules:
        if re.fullmatch(r[0], name):
            return r
    raise KeyError(f"no init rule matches the leaf {name!r}")


def _cdf(view: torch.Tensor) -> torch.Tensor:
    """Standard normal draws mapped to uniform ones on [0, 1]."""
    return 0.5 * (1.0 + torch.erf(view.float() / math.sqrt(2.0)))


def _apply(view: torch.Tensor, shape, rule) -> None:
    kind = rule[1]
    if kind == "normal":
        view.mul_(rule[3]).add_(rule[2])
    elif kind == "fan_in":
        view.mul_(1.0 / math.sqrt(shape[rule[2]]))
    elif kind == "uniform":
        lo, hi = rule[2], rule[3]
        view.copy_(lo + (hi - lo) * _cdf(view))
    elif kind == "dt_bias":
        # Mamba's time-step bias: softplus⁻¹ of a step log-uniform in [a, b]
        lo, hi = math.log(rule[2]), math.log(rule[3])
        dt = torch.exp(lo + (hi - lo) * _cdf(view))
        view.copy_(dt + torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(f"unknown init kind {kind!r}")


def draw(tree, rules, seed: int, device) -> Dict[str, torch.Tensor]:
    """{dotted name: leaf} of the tree's shapes and dtypes, on ``device``."""
    leaves = leaf_names(tree)
    dtypes = sorted({t.dtype for _, t in leaves}, key=str)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for dt in dtypes:
        group = [(n, t) for n, t in leaves if t.dtype == dt]
        total = sum(t.numel() for _, t in group)
        flat = torch.empty(total, dtype=dt, device=device)
        for lo in range(0, total, CHUNK):
            flat[lo:lo + CHUNK].normal_(generator=gen)
        off = 0
        for name, t in group:
            view = flat[off:off + t.numel()].view(t.shape)
            _apply(view, t.shape, rule_for(rules, name))
            out[name] = view
            off += t.numel()
    return out


def make_params(model, rules, seed: int, device):
    """The port's parameter tree, drawn by :func:`draw`."""
    tree = meta_tree(model)
    return rebuild(tree, draw(tree, rules, seed, device))
