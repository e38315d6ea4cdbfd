"""The plain training reference: the model of ``models.py`` in float32 and
AdamW with global-norm clipping and a linear warm-up into a cosine decay,
as the configuration and the traffic state them, followed for the first
steps of a run on the same batches and from the same draw of weights.

The weights and the moments are held in the dtypes the configuration
states (bf16 weights move by whole steps of their grid: a float32 copy
would drift from any sound program); every step computes in float32.

It returns readings: each step's loss and gradient norm (before
clipping), the norm of each leaf's first gradient as the optimizer gets it
(after clipping), the norm of each leaf's change over the steps followed,
and the distance of each leaf after them from the weights another side
ended on (``against``); where asked, also its own weights after them, on
the host in their stored dtypes (``final``).  The optimizer's state stays
on the card when it fits beside the parameters and a step's gradients, and
on the host otherwise.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from perfbench.reference import models

SLICE = 1 << 25
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def lr_at(count: int, opt: dict) -> float:
    """The learning rate of step ``count`` (from 1): linear warm-up over
    ``warmup`` steps, then a cosine from ``peak_lr`` to 0.1 of it at
    ``total``."""
    peak, warm, total = opt["peak_lr"], opt["warmup"], opt["total"]
    if count < warm:
        return peak * count / max(warm, 1)
    frac = min(max((count - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * frac)))


def _slices(t: torch.Tensor):
    flat = t.view(-1)
    return [flat[lo:lo + SLICE] for lo in range(0, flat.numel(), SLICE)]


def readings(params: Dict[str, torch.Tensor], stored: Dict[str, torch.dtype],
             m: dict, batches: List[tuple], opt: dict,
             p0: Callable[[], Dict[str, torch.Tensor]], loss_fn=models.loss,
             against: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
             keep_final: bool = False) -> dict:
    """Follow ``len(batches)`` AdamW steps from ``params`` (float32 leaves,
    updated in place, each held in its ``stored`` dtype), each step's loss
    ``loss_fn(params, m, *batch)``; ``p0()`` draws the first weights again
    for the change.  ``against`` names the final weights of other sides
    ({side: {leaf: tensor}}, on any device): ``param_leaf[side][leaf]`` is
    the norm of the difference."""
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    # the weights and the moments are held in the dtypes the configuration
    # states: each step computes in float32 and rounds what it stores
    mdt = DTYPES[opt.get("moment_dtype", "float32")]
    held_m = lambda x: x.to(mdt).float()    # noqa: E731
    names = list(params)
    leaves = [params[k] for k in names]
    nbytes = sum(t.numel() * 4 for t in leaves)
    dev = leaves[0].device
    on_card = dev.type != "cuda" or (
        torch.cuda.memory_allocated(dev) + 3 * nbytes + 16e9
        <= torch.cuda.get_device_properties(dev).total_memory)
    sdev = dev if on_card else torch.device("cpu")
    # after step 1 a leaf's moments are functions of its first gradient
    # alone, which is kept instead of them (the same bits, half the bytes)
    state: Dict[str, tuple] = {}
    out = {"loss": [], "grad_norm": [], "grad_leaf": {}, "delta_leaf": {}}
    last = len(batches) - 1
    for i, batch in enumerate(batches):
        req = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            loss = loss_fn(dict(zip(names, req)), m, *batch)
            grads = torch.autograd.grad(loss, req)
        del req
        norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads))
        scale = min(opt["clip_norm"] / max(norm, 1e-9), 1.0)
        count = i + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        lr = lr_at(count, opt)
        out["loss"].append(float(loss.detach()))
        out["grad_norm"].append(norm)
        for k, p, g in zip(names, leaves, grads):
            held_w = lambda x: x.to(stored[k]).float()    # noqa: E731
            if i == 0:
                out["grad_leaf"][k] = float(torch.linalg.vector_norm(g)) * scale
            decay = p.ndim >= 2
            kind, *held = state.get(k, ("zero",))
            keep_g = i == 0 and i != last
            keep_mv = i > 0 and i != last
            new = ((torch.empty(p.shape, device=sdev),) if keep_g else
                   (torch.empty(p.shape, device=sdev),
                    torch.empty(p.shape, device=sdev)) if keep_mv else ())
            for j, (ps, gs) in enumerate(zip(_slices(p), _slices(g))):
                gf = gs * scale
                if kind == "zero":
                    mf = held_m((1 - b1) * gf)
                    vf = held_m((1 - b2) * gf * gf)
                else:
                    if kind == "g1":
                        g1 = _slices(held[0])[j].to(dev)
                        mp, vp = held_m((1 - b1) * g1), held_m((1 - b2) * g1 * g1)
                    else:
                        mp, vp = (_slices(h)[j].to(dev) for h in held)
                    mf = held_m(b1 * mp + (1 - b1) * gf)
                    vf = held_m(b2 * vp + (1 - b2) * gf * gf)
                step = (mf / c1) / (torch.sqrt(vf / c2) + eps)
                if decay:
                    step = step + wd * ps
                if keep_g:
                    _slices(new[0])[j].copy_(gf)
                elif keep_mv:
                    _slices(new[0])[j].copy_(mf)
                    _slices(new[1])[j].copy_(vf)
                ps.copy_(held_w(ps - lr * step))
            state[k] = ("g1", *new) if keep_g else ("mv", *new) if keep_mv else ("zero",)
        del grads
    del state
    first = p0()
    for k in names:
        d = params[k] - first.pop(k).float()
        out["delta_leaf"][k] = float(torch.linalg.vector_norm(d))
        del d
    out["param_leaf"] = {side: {k: _distance(params[k], fin[k]) for k in names}
                         for side, fin in (against or {}).items()}
    if keep_final:
        out["final"] = {k: params[k].to(stored[k]).cpu() for k in names}
    return out


def _distance(p: torch.Tensor, other: torch.Tensor) -> float:
    """The float32 norm of ``p - other``, a slice at a time on ``p``'s
    device."""
    total = 0.0
    for ps, os_ in zip(_slices(p), _slices(other.contiguous())):
        d = ps - os_.to(ps.device).float()
        total += float(torch.sum(d * d))
    return math.sqrt(total)
