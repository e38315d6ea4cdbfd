"""Name-based parameter sharding rules (DP/FSDP/TP over logical axes), the
port of ``repro.distributed.sharding``.

Strategy, as the reference's:

* batch over the data-parallel axes (``("data",)``, or ``("pod", "data")``),
* FSDP (ZeRO-3): parameters AND optimizer state sharded over ``"data"``,
  gathered on use (DTensor's redistribution, where the reference has GSPMD),
* TP (Megatron): attention heads / MLP hidden / vocab over ``"model"``,
* the embedding and head tables 2-D blocked (vocab x d_model) over
  ("model" x "data"),
* experts: TP over d_ff within each expert + FSDP over d_model,
* everything else (norms, scalars, ``a_log``, ...) replicated.

Rules match on the path suffix of each parameter leaf; leading stacked-layer
dims are padded with ``None``.  A layout is a :class:`Spec`, the port's
``PartitionSpec``: a tuple with one entry per tensor dim, each ``None``, a
mesh axis name or a tuple of names.  A *sharding* is a :class:`Sharding`,
a ``DeviceMesh`` and the DTensor placements of a spec
(``core.placement.spec_placements``); :func:`distribute` places a tree by a
tree of them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.core import placement as _pl


class Spec(tuple):
    """``PartitionSpec``: ``Spec("data", None)``; a leaf of spec trees.  As
    jax's, an entry naming one axis in a tuple is that axis' name."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leaf lives: ``mesh`` and the placements of ``spec`` on it."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return _pl.spec_placements(self.mesh, self.spec)

    def place(self, whole: torch.Tensor):
        """``whole``, which every rank of the mesh holds alike, as a DTensor
        laid out by this sharding: each rank keeps a copy of its shard
        (nothing moves, and the result shares no memory with ``whole``)."""
        d = _pl.place(whole, self.mesh, self.placements)
        return _pl.rewrap(d.to_local().clone(), d)


def _is_spec(x) -> bool:
    return isinstance(x, Spec)


# (regex on leaf path, spec on the leaf's LAST len(spec) dims)
_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings / heads: 2-D ds-array blocking (vocab x d_model)
    (r"embed$",                    ("model", "data")),
    (r"lm_head$",                  ("data", "model")),
    (r"frontend_proj$",            (None, "model")),
    (r"mm_proj/w1$",               (None, "model")),
    (r"mm_proj/w2$",               ("data", "model")),
    # attention: FSDP on d_model, TP on heads
    (r"attn/w[qkv]$",              ("data", "model")),
    (r"(self|cross)_attn/w[qkv]$", ("data", "model")),
    (r"attn/wo$",                  ("model", "data")),
    (r"(self|cross)_attn/wo$",     ("model", "data")),
    (r"attn/b[qkv]$",              ("model",)),
    # dense MLP
    (r"mlp/w_(gate|up)$",          ("data", "model")),
    (r"mlp/w_down$",               ("model", "data")),
    # MoE: experts replicated on E, FSDP on d, TP on f
    (r"moe/router$",               ("data", None)),
    (r"moe/w_(gate|up)$",          (None, "data", "model")),
    (r"moe/w_down$",               (None, "model", "data")),
    # mamba2
    (r"in_proj$",                  ("data", "model")),
    (r"out_proj$",                 ("model", "data")),
    (r"conv_w$",                   (None, "model")),
    (r"conv_b$",                   ("model",)),
    (r"gate_norm$",                ("model",)),
)


def spec_for_path(path: str, ndim: int) -> Spec:
    for pat, suffix in _RULES:
        if re.search(pat, path):
            if len(suffix) > ndim:
                return Spec()
            return Spec(*((None,) * (ndim - len(suffix)) + tuple(suffix)))
    return Spec()


def tree_paths(tree):
    """(paths, leaves, unflatten): the leaves of a tree of dicts, lists and
    tuples in ``jax.tree_util``'s order, each path the ``/``-joined keys
    the reference joins (``checkpoint``'s flattening)."""
    return _flatten_with_paths(tree)


def _axis_extent(mesh, names) -> int:
    if names is None:
        return 1
    size = 1
    for n in ((names,) if isinstance(names, str) else names):
        size *= _pl.axis_size(mesh, n)
    return size


def sanitize_spec(spec: Sequence, shape, mesh) -> Spec:
    """Replicate any dim the mesh extent does not divide evenly."""
    return Spec(*(None if names is not None and (
        i >= len(shape) or shape[i] % _axis_extent(mesh, names) != 0)
        else names for i, names in enumerate(spec)))


def _leaf_specs(params, mesh):
    """(leaves, their specs, unflatten) of a parameter tree."""
    paths, leaves, unflatten = tree_paths(params)
    specs = [spec_for_path(p, getattr(l, "ndim", 0)) for p, l in zip(paths, leaves)]
    if mesh is not None:
        specs = [sanitize_spec(s, tuple(getattr(l, "shape", ())), mesh)
                 for s, l in zip(specs, leaves)]
    return leaves, specs, unflatten


def param_specs(params, mesh=None) -> Any:
    """Tree of :class:`Spec` matching ``params`` (sanitized if mesh given)."""
    _, specs, unflatten = _leaf_specs(params, mesh)
    return unflatten(specs)


def to_shardings(specs, mesh) -> Any:
    return pytree.tree_map(lambda s: Sharding(mesh, s), specs, is_leaf=_is_spec)


def param_shardings(params, mesh) -> Any:
    return to_shardings(param_specs(params, mesh), mesh)


# -- activation / batch / cache shardings -------------------------------------

_CACHE_RULES = (
    (r"(attn_k|attn_v|k|v)$", (None, "dp", None, "model", None)),  # (L,B,H,T,hd)
    (r"enc_out$",             ("dp", None, "model")),              # (B,T,D)
    (r"conv$",                (None, "dp", None, "model")),        # (L,B,K,C)
    (r"h$",                   (None, "dp", "model", None, None)),  # (L,B,H,S,P)
)


def _expand_dp(names, dp: Tuple[str, ...]):
    return dp if names == "dp" else names


def cache_specs(cache, mesh, dp: Tuple[str, ...]) -> Any:
    """Specs of a decode cache's leaves (an int ``pos`` replicates)."""
    paths, leaves, unflatten = tree_paths(cache)
    out = []
    for p, l in zip(paths, leaves):
        ndim = getattr(l, "ndim", 0)
        spec = Spec()
        for pat, suffix in _CACHE_RULES:
            if re.search(pat, p) and len(suffix) == ndim:
                spec = Spec(*[_expand_dp(n, dp) for n in suffix])
                break
        out.append(sanitize_spec(spec, tuple(getattr(l, "shape", ())), mesh))
    return unflatten(out)


def batch_specs(batch, mesh, dp: Tuple[str, ...]) -> Any:
    """Shard every batch leaf's leading dim over the dp axes (a ``Batch``
    of specs for a ``Batch``; ``None`` fields stay ``None``)."""
    def spec(leaf):
        ndim = getattr(leaf, "ndim", 0)
        s = Spec(tuple(dp), *([None] * (ndim - 1))) if ndim >= 1 else Spec()
        return sanitize_spec(s, tuple(getattr(leaf, "shape", ())), mesh)
    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: None if getattr(batch, f.name) is None
            else spec(getattr(batch, f.name)) for f in dataclasses.fields(batch)})
    return pytree.tree_map(spec, batch)


def opt_state_shardings(opt_state, params, mesh) -> Any:
    """Optimizer-state leaves inherit the sharding of the matching param by
    SHAPE (moments are param-shaped; scalars/factored vectors replicate)."""
    leaves, specs, _ = _leaf_specs(params, mesh)
    pspecs = {tuple(l.shape): s for l, s in zip(leaves, specs)}
    return pytree.tree_map(
        lambda leaf: Sharding(mesh, pspecs.get(tuple(getattr(leaf, "shape", ())),
                                               Spec())), opt_state)


def distribute(tree, shardings) -> Any:
    """``tree`` placed leaf by leaf as ``shardings`` (a tree of the same
    structure with a :class:`Sharding` or ``None`` per leaf) says
    (:meth:`Sharding.place`: every rank holds the whole tree alike, the same
    init or the same batch)."""
    paths, leaves, unflatten = tree_paths(tree)
    _, shs, _ = spec_tree_paths(shardings)
    if len(shs) != len(leaves):
        raise ValueError(f"{len(shs)} shardings for {len(leaves)} leaves")
    out = []
    for leaf, sh in zip(leaves, shs):
        if sh is None or not isinstance(leaf, torch.Tensor) or _pl.is_dtensor(leaf):
            out.append(leaf)            # a cache's int position stays as it is
            continue
        out.append(sh.place(leaf))
    return unflatten(out)


def spec_tree_paths(shardings):
    """``tree_paths`` of a tree whose leaves are :class:`Sharding`,
    :class:`Spec` or ``None`` (each kept as one leaf, in the order of the
    tree it lays out)."""
    marked = pytree.tree_map(lambda x: _Leaf(x), shardings,
                             is_leaf=lambda x: x is None or isinstance(x, (Sharding, Spec)))
    paths, leaves, unflatten = tree_paths(marked)
    return paths, [x.value for x in leaves], unflatten


class _Leaf:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value
