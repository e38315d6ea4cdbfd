"""AdamW and Adafactor, from scratch, pytree-functional over the parameter
dict: the port of ``repro.optim.adamw``.

The arithmetic is the reference's, in its order: the clip scale, the
moments, ``b1 ** count``, the bias corrections and the schedule in fp32,
the update computed in fp32 and cast back to each parameter's dtype, and
decoupled weight decay wherever ``p.ndim >= 2`` (the stacked per-layer
norms ``(L, d)`` included, as in the reference).

Two things differ, both for memory.  ``update`` works along the leading
(layer) axis of every stacked leaf of three or more dims, a slice of at
most ``SLICE_ELEMS`` elements at a time, so that its fp32 temporaries are
those of a slice: zamba2-2.7b's ``layers/in_proj`` is one leaf of 1.44 G
elements, and a whole-leaf transcription would hold about seven fp32
copies of it.  And ``update`` consumes its state, as the reference's
jitted step donates it: the moments, the parameters and Adafactor's
factors are written in place and returned in the new trees.  Reuse no
state or parameter tree after passing it to ``update``.

Over a mesh the leaves are DTensors (``distributed.sharding``): the global
gradient norm is one all-reduce of each rank's weighted sum of squares,
so the clip factor is the same on every rank; AdamW then updates each
rank's shards in place (its step is elementwise), Adafactor's factored
moments run on the DTensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import placement as _pl

Params = Any

#: the most elements of one slice of a stacked leaf that ``update`` works on
SLICE_ELEMS = 1 << 25

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _slice_step(t: torch.Tensor) -> Optional[int]:
    """Layers per slice of a leaf of three or more dims and more than
    ``SLICE_ELEMS`` elements: at most ``SLICE_ELEMS`` elements, one layer
    at least.  None (no slicing) for any other leaf."""
    if t.ndim < 3 or t.numel() <= SLICE_ELEMS:
        return None
    return max(1, SLICE_ELEMS // (t.numel() // t.shape[0]))


def _slices(t: torch.Tensor, step: Optional[int]):
    """Views of ``t`` along its leading axis, ``step`` layers each (all of
    ``t`` for None)."""
    return (t,) if step is None else torch.split(t, step, dim=0)


def _walk(like, *trees) -> Iterator[tuple]:
    """The leaves of ``like`` (nested dicts, lists and tuples), each with the
    subtrees at the same place in ``trees`` (which may go deeper there, as
    Adafactor's factor dicts do), whatever their dicts' key order."""
    if isinstance(like, dict):
        for key in like:
            yield from _walk(like[key], *(t[key] for t in trees))
    elif isinstance(like, (list, tuple)):
        for i, sub in enumerate(like):
            yield from _walk(sub, *(t[i] for t in trees))
    else:
        yield (like, *trees)


def _replicas(x, world: int) -> int:
    """How many ranks hold each element of ``x``: a DTensor's product of
    its replicated mesh dims, a plain tensor on every rank of ``world``."""
    if not _pl.is_dtensor(x):
        return world
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_partial():
            raise ValueError("global_norm of a partial-sum DTensor")
        if p.is_replicate():
            n *= x.device_mesh.size(i)
    return n


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x²), each term in fp32.  With
    DTensor leaves (whose mesh covers the process group) each rank sums
    its shards, each divided by its number of holders, and one all-reduce
    adds the ranks' sums: the norm is the same plain tensor on every
    rank."""
    leaves = pytree.tree_leaves(tree)
    placed = [x for x in leaves if _pl.is_dtensor(x)]
    world = 1
    if placed:
        import torch.distributed as dist
        world = dist.get_world_size()
        if placed[0].device_mesh.size() != world:
            raise ValueError(f"a mesh of {placed[0].device_mesh.size()} ranks in "
                             f"a process group of {world}")
    total = 0
    for x in leaves:
        loc = _pl.local(x)
        term = sum(torch.sum(torch.square(s.float()))
                   for s in _slices(loc, _slice_step(loc)))
        total = total + (term / _replicas(x, world) if placed else term)
    total = torch.as_tensor(total, dtype=torch.float32)
    if placed:
        dist.all_reduce(total)
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled to global norm at most ``max_norm``, each leaf in its
    dtype, the norm before)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return pytree.tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _aligned(t, like):
    """``t`` laid out as ``like``: itself when they agree (or are plain),
    else a redistributed copy, to be written back with :func:`_assign`."""
    if not _pl.is_dtensor(t) or tuple(t.placements) == tuple(like.placements):
        return t
    return t.redistribute(like.device_mesh, like.placements)


def _assign(dst, src) -> None:
    """``dst.copy_(src)``, ``src`` redistributed to ``dst``'s layout first."""
    if _pl.is_dtensor(dst) and tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    if src is not dst:
        dst.copy_(src)


def _count(params) -> torch.Tensor:
    """The step count, int32 zero, beside the parameters: replicated on
    their mesh when they are DTensors."""
    first = pytree.tree_leaves(params)[0]
    count = torch.zeros((), dtype=torch.int32, device=_pl.local(first).device)
    if not _pl.is_dtensor(first):
        return count
    from torch.distributed.tensor import Replicate
    mesh = first.device_mesh
    return _pl.place(count, mesh, (Replicate(),) * mesh.ndim)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A slice of a gradient clipped as ``clip_by_global_norm`` clips it
    (rounded to the gradient's dtype), then in fp32 as ``update`` reads it."""
    return (g.float() * scale).to(g.dtype).float()


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor]   # step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # "bfloat16" halves optimizer memory

    def init(self, params: Params) -> Params:
        mdt = _DTYPES[self.moment_dtype]
        zeros = lambda p: torch.zeros_like(p, dtype=mdt,  # noqa: E731
                                           memory_format=torch.contiguous_format)
        return {"m": pytree.tree_map(zeros, params),
                "v": pytree.tree_map(zeros, params), "count": _count(params)}

    def update(self, grads: Params, state: Params, params: Params
               ) -> Tuple[Params, Params, Dict[str, torch.Tensor]]:
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, self.clip_norm)
        count = state["count"] + 1
        b1, b2 = self.b1, self.b2
        c1 = 1 - b1 ** _pl.local(count).float()
        c2 = 1 - b2 ** _pl.local(count).float()
        lr = self.learning_rate(_pl.local(count))
        for p, g, m, v in _walk(params, grads, state["m"], state["v"]):
            decay = p.ndim >= 2       # decoupled weight decay on matrices only
            # each rank steps its own shards (the step is elementwise)
            gm, mm, vm = (_aligned(t, p) for t in (g, m, v))
            pl, gl, ml, vl = (_pl.local(t) for t in (p, gm, mm, vm))
            n = _slice_step(pl)
            for ps, gs, ms, vs in zip(*(_slices(t, n) for t in (pl, gl, ml, vl))):
                gf = _clipped(gs, scale)
                mf = b1 * ms.float() + (1 - b1) * gf
                vf = b2 * vs.float() + (1 - b2) * gf * gf
                step = (mf / c1) / (torch.sqrt(vf / c2) + self.eps)
                if decay:
                    step = step + self.weight_decay * ps.float()
                ms.copy_(mf)
                vs.copy_(vf)
                ps.copy_(ps.float() - lr * step)
            _assign(m, mm)
            _assign(v, vm)
        new_state = {"m": state["m"], "v": state["v"], "count": count}
        return params, new_state, {"grad_norm": gnorm, "lr": lr}


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second moments (Shazeer & Stern): O(n+m) optimizer memory per
    (n, m) matrix instead of O(n·m) — the huge-model option."""
    learning_rate: Callable[[torch.Tensor], torch.Tensor]
    decay: float = 0.8
    eps: float = 1e-30
    clip_norm: float = 1.0
    weight_decay: float = 0.0

    def init(self, params: Params) -> Params:
        def zeros(p, shape):
            # fp32 zeros beside p: replicated on p's mesh for a DTensor
            z = torch.zeros(shape, dtype=torch.float32, device=_pl.local(p).device)
            if not _pl.is_dtensor(p):
                return z
            from torch.distributed.tensor import Replicate
            return _pl.place(z, p.device_mesh, (Replicate(),) * p.device_mesh.ndim)

        def factored(p):
            if p.ndim >= 2:
                return {"vr": zeros(p, p.shape[:-1]),
                        "vc": zeros(p, p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p, p.shape)}
        return {"v": pytree.tree_map(factored, params), "count": _count(params)}

    def _upd(self, gf, v, p, beta):
        """One slice's step (fp32) and its moments, written into ``v``."""
        g2 = gf * gf + self.eps
        if p.ndim >= 2:
            vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
            vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(dim=-1)[..., None, None], min=self.eps))
            step = gf / torch.sqrt(denom + self.eps)
            _assign(v["vr"], vr)
            _assign(v["vc"], vc)
        else:
            nv = beta * v["v"] + (1 - beta) * g2
            step = gf / torch.sqrt(nv + self.eps)
            _assign(v["v"], nv)
        if p.ndim >= 2 and self.weight_decay:
            step = step + self.weight_decay * p.float()
        return step

    def update(self, grads, state, params):
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, self.clip_norm)
        count = state["count"] + 1
        beta = 1.0 - (_pl.local(count).float() + 1.0) ** (-self.decay)
        lr = self.learning_rate(_pl.local(count))
        for p, g, v in _walk(params, grads, state["v"]):
            # a stacked leaf's factors are per layer: sliced alike
            n, keys = _slice_step(p), sorted(v)
            for ps, gs, *vs in zip(*(_slices(t, n) for t in
                                     (p, g, *(v[key] for key in keys)))):
                step = self._upd(_clipped(_aligned(gs, ps), scale),
                                 dict(zip(keys, vs)), ps, beta)
                _assign(ps, (ps.float() - lr * step).to(ps.dtype))
        return params, {"v": state["v"], "count": count}, \
            {"grad_norm": gnorm, "lr": lr}


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    def lr(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def make_optimizer(kind: str, peak_lr: float = 3e-4, warmup: int = 100,
                   total: int = 10000, moment_dtype: str = "float32",
                   weight_decay: float = 0.1):
    sched = cosine_schedule(peak_lr, warmup, total)
    if kind == "adamw":
        return AdamW(learning_rate=sched, moment_dtype=moment_dtype,
                     weight_decay=weight_decay)
    if kind == "adafactor":
        return Adafactor(learning_rate=sched, weight_decay=weight_decay)
    raise KeyError(kind)
