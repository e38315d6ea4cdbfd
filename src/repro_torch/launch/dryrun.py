"""Multi-node dry run: trace one step of every (arch x shape x mesh) cell on
a fake 256- or 512-rank H100 mesh, the port of ``repro.launch.dryrun``.

For each cell this builds the production mesh (``launch.mesh``: 32 nodes of
8 H100s, ``("data", "model")`` = (32, 8), or 64 nodes, (2, 32, 8)) on
torch's ``fake`` process group, which moves nothing, in this one process;
places the model's state and the cell's inputs by the reference's sharding
rules as ``meta`` tensors (shapes and dtypes, no data, no memory); and runs
ONE train step (or the prefill step, or one decode step) through the
port's own code under ``ShardEnv(..., mode=)`` with :mod:`launch.costs`
recording.  Success proves the distribution config is coherent; the live
bytes of rank 0's local tensors over the step say whether it fits an
80 GB card (the reference's ``memory_analysis()``); the flops, bytes and
collective bytes of rank 0's local ops feed the roofline (the reference's
``cost_analysis()`` and ``benchmarks/hlo_analysis.py``).  Nothing needs a
card: the kernels' wrappers give ``meta`` operands the shapes of their
outputs.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
        --multi-pod both --out results/dryrun_torch.json

The reference's ``--no-banded`` (dense attention as the paper's baseline)
has no counterpart: the port's attention kernel computes the band alone
(the ``banded`` switch went in the port's first LM slice).  ``compile_s``
has none either: nothing is compiled; ``trace_s`` is the traced step's
host seconds.  :func:`estimate` is the step under a cell without the
production mesh: any config, batch shape, optimizer and accumulation, on a
given mesh or none (one card's program, which ``chip_smoke.py`` holds to
the card's allocator).
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.data.pipeline import Batch
from repro_torch.distributed import sharding as shlib
from repro_torch.launch import costs
from repro_torch.launch import specs as speclib
from repro_torch.launch.mesh import dp_axes, fake_process_group, make_production_mesh
from repro_torch.models import common as cm
from repro_torch.models.config import SHAPE_CELLS, ModelConfig, ShapeCell, get_shape_cell
from repro_torch.models.model import Model, build_model
from repro_torch.optim import make_optimizer
from repro_torch.train.step import TrainState, init_state, make_train_step

SHAPES = tuple(c.name for c in SHAPE_CELLS)


def pick_optimizer(cfg, total_params: int):
    """Memory-driven optimizer policy (see EXPERIMENTS.md §Dry-run)."""
    if total_params > 100e9:
        return make_optimizer("adafactor"), "adafactor"
    if total_params > 5e9:
        return make_optimizer("adamw", moment_dtype="bfloat16"), "adamw-bf16"
    return make_optimizer("adamw"), "adamw-fp32"


def pick_accum(cfg) -> Tuple[int, str]:
    """Per-arch microbatching policy for train_4k so activations + grad
    accumulators fit 16 GiB HBM (derived empirically from memory_analysis;
    recorded in EXPERIMENTS.md §Dry-run)."""
    if cfg.param_count() > 100e9:           # grok-1-314b
        return 16, "bfloat16"
    if cfg.family == "moe":
        return 2, "float32"                 # mixtral (tp_sp)
    if cfg.family == "hybrid":
        return 2, "float32"                 # zamba2 (tp_sp; fsdp needs >16G)
    return 1, "float32"


def pick_mode(cfg: ModelConfig, cell: ShapeCell, ranks: int,
              accum_steps: Optional[int] = None, mode: str = "auto") -> str:
    """The sharding mode of a cell over ``ranks`` ranks (the dp axes and
    ``model``), the reference's inline policy: ``fsdp`` needs a train cell
    whose every MICROBATCH covers the whole mesh, weight gathers cheaper
    than activation reshards (no MoE or hybrid, under 20 B parameters) and
    per-device activations that fit (``d_ff`` <= 16,384); ``auto`` takes
    ``fsdp`` where it may, else ``tp_sp``; an ``fsdp`` request that may not
    becomes ``tp_sp``; ``tp_sp`` stays."""
    if mode not in ("fsdp", "auto"):
        return mode
    accum_probe = accum_steps or pick_accum(cfg)[0]
    micro = cell.global_batch // max(accum_probe, 1)
    fsdp_ok = (cell.kind == "train" and micro % ranks == 0
               and cfg.family not in ("moe", "hybrid")
               and cfg.param_count() < 20e9 and cfg.d_ff <= 16384)
    return "fsdp" if fsdp_ok else "tp_sp"


def fit_accum(accum_steps: int, global_batch: int, dp_total: int) -> int:
    """Halve the accumulation until every microbatch divides by the dp
    extent (else the batch sharding sanitizes away and compute
    replicates)."""
    while accum_steps > 1 and (global_batch // accum_steps) % dp_total:
        accum_steps //= 2
    return accum_steps


def _placed(tree, mesh, specs_fn):
    """``tree`` (a tree or a ``Batch``) placed on ``mesh`` by
    ``specs_fn(tree)``; as it is with no mesh."""
    if mesh is None:
        return tree
    specs = specs_fn(tree)
    if isinstance(tree, Batch):
        return Batch(*(None if t is None else shlib.Sharding(mesh, sp).place(t)
                       for t, sp in ((tree.tokens, specs.tokens),
                                     (tree.labels, specs.labels),
                                     (tree.patches, specs.patches))))
    return shlib.distribute(tree, shlib.to_shardings(specs, mesh))


def _forward_hidden(model: Model, params, batch: Batch, env):
    fn = model.module.forward_hidden
    kw = {"patches": batch.patches} if "patches" in inspect.signature(fn).parameters else {}
    return fn(params, model.cfg, batch.tokens, env=env, **kw)


def estimate(cfg: ModelConfig, cell: ShapeCell, optimizer=None,
             accum_steps: int = 1, mesh=None, *, dp: Tuple[str, ...] = ("data",),
             accum_dtype: str = "float32", compile_: bool = True,
             **env_kw) -> Dict[str, Any]:
    """One step of ``cell`` (a train step with ``optimizer`` and
    ``accum_steps``, the prefill step, or one decode step) for ``cfg`` on
    ``meta`` tensors, on ``mesh`` (placed by the reference's rules over the
    dp axes ``dp``; ``env_kw`` goes to ``ShardEnv``) or, with no mesh, one
    card's unsharded program.  Returns ``lower_s``, and unless
    ``compile_`` is false, ``trace_s``, ``memory``, ``cost`` and ``hlo``
    (rank 0's, :mod:`launch.costs`)."""
    t0 = time.time()
    model = build_model(cfg)
    env = cm.ShardEnv(mesh=mesh, dp=dp, tp="model", **env_kw) if mesh is not None else cm.NO_SHARD
    gen = torch.Generator().manual_seed(0)
    meta = speclib.META
    if cell.kind == "train":
        state = init_state(model, optimizer, gen, meta)
        if mesh is not None:
            state = shlib.distribute(state, TrainState(
                params=shlib.param_shardings(state.params, mesh),
                opt_state=shlib.opt_state_shardings(state.opt_state, state.params, mesh)))
        batch = speclib.batch_spec(cfg, cell)
        batch = _placed(batch, mesh, lambda b: shlib.batch_specs(b, mesh, env.batch_axes))
        step = make_train_step(model, optimizer, env, accum_steps=accum_steps,
                               accum_dtype=accum_dtype)
        args = (state, batch)
    else:
        params = model.init(gen, meta)
        if mesh is not None:
            params = shlib.distribute(params, shlib.param_shardings(params, mesh))
        if cell.kind == "prefill":
            batch = speclib.batch_spec(cfg, cell)
            batch = _placed(batch, mesh, lambda b: shlib.batch_specs(b, mesh, dp))

            def step(params, batch):
                with torch.no_grad():
                    hidden, _ = _forward_hidden(model, params, batch, env)
                    last = hidden[:, -1:, :]
                    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
                    return env.linear(last.float(), head.float())
            args = (params, batch)
        else:
            d = speclib.decode_specs(model, cell)
            cache = _placed(d["cache"], mesh, lambda c: shlib.cache_specs(c, mesh, dp))
            tokens = _placed(d["tokens"], mesh, lambda t: shlib.batch_specs(t, mesh, dp))

            def step(params, cache, tokens):
                with torch.no_grad():
                    return model.decode_step(params, cache, tokens, env)
            args = (params, cache, tokens)
    out: Dict[str, Any] = {"lower_s": round(time.time() - t0, 1)}
    if not compile_:
        return out
    t1 = time.time()
    with costs.recording(mesh) as rec:
        arg_bytes = rec.track(args)
        result = step(*args)
    out["trace_s"] = round(time.time() - t1, 1)
    out["memory"] = {"argument_bytes": arg_bytes,
                     "output_bytes": costs.storage_bytes(result),
                     "temp_bytes": rec.peak - arg_bytes,
                     "peak_bytes": rec.peak}
    hlo = rec.hlo()
    out["cost"] = {"flops": hlo["flops"], "bytes_accessed": hlo["hbm_bytes"]}
    out["hlo"] = hlo
    out["kernel_calls"] = dict(rec.kernels)
    return out


def lower_cell(arch: str, shape: str, multi_pod: bool,
               accum_steps: Optional[int] = None, compile_: bool = True,
               vocab_parallel: bool = True, bf16_tp_reduce: bool = False,
               gather_weights: bool = True, mode: str = "auto") -> Dict[str, Any]:
    """One cell on the production mesh, which needs the default process
    group to hold its 256 (512 with ``multi_pod``) ranks: a fake one
    (:func:`launch.mesh.fake_process_group`, as :func:`main` makes) or a
    real job's."""
    t0 = time.time()
    cfg = get_config(arch)
    cell = get_shape_cell(shape)
    ok, why = speclib.cell_supported(cfg, cell)
    if not ok:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}

    mesh = make_production_mesh(multi_pod=multi_pod)
    dp = dp_axes(multi_pod)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    mode = pick_mode(cfg, cell, math.prod(sizes[n] for n in dp + ("model",)),
                     accum_steps, mode)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape, "multi_pod": multi_pod, "kind": cell.kind,
        "params_b": cfg.param_count() / 1e9,
        "active_params_b": cfg.active_param_count() / 1e9}
    opt, accum_dtype = None, "float32"
    if cell.kind == "train":
        opt, opt_name = pick_optimizer(cfg, cfg.param_count())
        auto_accum, accum_dtype = pick_accum(cfg)
        if accum_steps is None:
            accum_steps = auto_accum
        accum_steps = fit_accum(accum_steps, cell.global_batch,
                                math.prod(sizes[n] for n in dp))
        result.update(optimizer=opt_name, accum_steps=accum_steps, mode=mode)
    est = estimate(cfg, cell, opt, accum_steps or 1, mesh, dp=dp,
                   accum_dtype=accum_dtype, compile_=compile_,
                   vocab_parallel=vocab_parallel, bf16_tp_reduce=bf16_tp_reduce,
                   gather_weights=gather_weights, mode=mode)
    result["lower_s"] = est.pop("lower_s")
    if not compile_:
        result["status"] = "lowered"
        return result
    result.update(est)
    result["chips"] = 512 if multi_pod else 256
    result["status"] = "ok"
    result["total_s"] = round(time.time() - t0, 1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"],
                    default="off")
    ap.add_argument("--accum-steps", type=int, default=None)
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    archs = all_arch_ids() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]

    results = []
    for mp in pods:
        with fake_process_group(512 if mp else 256):
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch} x {shape} x {'2pod' if mp else '1pod'}"
                    try:
                        r = lower_cell(arch, shape, mp,
                                       accum_steps=args.accum_steps,
                                       compile_=not args.no_compile)
                    except Exception as e:                   # noqa: BLE001
                        r = {"arch": arch, "shape": shape, "multi_pod": mp,
                             "status": "error", "error": str(e),
                             "traceback": traceback.format_exc()}
                    results.append(r)
                    status = r["status"]
                    extra = ""
                    if status == "ok":
                        peak = (r.get("memory") or {}).get("temp_bytes")
                        hlo = r.get("hlo", {})
                        extra = (f" flops/dev={hlo.get('flops', 0):.3e}"
                                 f" coll/dev={hlo.get('collective_bytes', 0):.3e}B"
                                 f" temp={peak/2**30 if peak else -1:.2f}GiB"
                                 f" ({r.get('total_s')}s)")
                    elif status == "error":
                        extra = " " + r["error"][:200]
                    print(f"[{status:7s}] {tag}{extra}", flush=True)

    # the reference's order: arch, shape, then pod
    results.sort(key=lambda r: (archs.index(r["arch"]), shapes.index(r["shape"]),
                                r["multi_pod"]))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", args.out)
    n_err = sum(1 for r in results if r["status"] == "error")
    print(f"done: {len(results)} cells, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
