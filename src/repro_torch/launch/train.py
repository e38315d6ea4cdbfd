"""End-to-end training driver (fault-tolerant), the port of
``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --smoke --device cpu --steps 200 --batch 8 --seq 128 --ckpt-dir CKPT
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --steps 100 --batch 2 --seq 4096           # on the card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-medium --batch 4 --seq 1024   # 1,024 frames, 1,024 tokens

One card, or the CPU when ``--device cpu`` names it.  ``--mesh`` trains
over a device mesh, one process per rank under ``torchrun`` (NCCL on the
cards, gloo with ``--device cpu``)::

    torchrun --nproc_per_node 4 -m repro_torch.launch.train --arch yi-9b \
        --smoke --device cpu --mesh data=2,model=2
    torchrun --nproc_per_node 4 -m repro_torch.launch.train --arch yi-9b \
        --mesh data=2,model=2                        # four cards

The state is placed by ``distributed.sharding.param_shardings`` /
``opt_state_shardings``, the batch by ``batch_specs``; ``dp`` is every mesh
axis but ``model``, which is the tensor-parallel axis.  Only rank 0 prints
and beats the heartbeat.  Features: the deterministic synthetic pipeline,
AdamW + cosine, per-group remat, async checkpointing, automatic resume
(onto the current mesh, whatever mesh saved it), heartbeat, optional crash
injection to exercise the restart path.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.compat import make_mesh
from repro_torch.core.dsarray import resolve_device
from repro_torch.data.pipeline import pipeline_for_model
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.fault_tolerance import Heartbeat, run_with_restarts
from repro_torch.models import common as cm
from repro_torch.models.model import build_model
from repro_torch.optim import make_optimizer
from repro_torch.train.step import TrainState, init_state, make_train_step


def parse_mesh(spec: str, device: torch.device):
    """(mesh, dp axes) of ``--mesh`` (``data=2,model=2``): the mesh over the
    initialised process group (initialised here from ``torchrun``'s
    environment when it is not yet: NCCL for a CUDA device, gloo for the
    CPU); ``(None, ("data",))`` for no mesh."""
    if not spec:
        return None, ("data",)
    names, shape = [], []
    for part in spec.split(","):
        k, v = part.split("=")
        names.append(k)
        shape.append(int(v))
    import torch.distributed as dist
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError(f"--mesh {spec}: start one process per rank with "
                               f"torchrun (no process group, no RANK)")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    mesh = make_mesh(tuple(shape), tuple(names), device_type=device.type)
    return mesh, tuple(n for n in names if n != "model")


def main(argv=None):
    """Train, checkpointing and resuming; returns the final ``TrainState``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--mesh", default="", help="e.g. data=2,model=2 "
                                               "(under torchrun)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="inject a failure at this step (tests restart)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.mesh and device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    mesh, dp = parse_mesh(args.mesh, device)
    lead = mesh is None or mesh.get_rank() == 0
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    env = cm.ShardEnv(mesh=mesh, dp=dp, tp="model") if mesh else cm.NO_SHARD
    pipe = pipeline_for_model(cfg, args.batch, args.seq, mesh, dp, device=device)
    opt = make_optimizer(args.optimizer, peak_lr=args.lr, warmup=10,
                         total=args.steps)
    train_step = make_train_step(model, opt, env, accum_steps=args.accum_steps)

    state_shardings = None
    if mesh is not None:
        abstract = init_state(model, opt, torch.Generator().manual_seed(0), "meta")
        state_shardings = TrainState(
            params=shlib.param_shardings(abstract.params, mesh),
            opt_state=shlib.opt_state_shardings(abstract.opt_state,
                                                abstract.params, mesh))

    def make_init():
        state = init_state(model, opt, torch.Generator(device).manual_seed(0),
                           device)
        return state if mesh is None else shlib.distribute(state, state_shardings)

    hb = Heartbeat(os.path.join(args.ckpt_dir, "heartbeat.json")) if lead else None
    crashed = {"done": False}
    losses = []
    t0 = time.time()

    def step_fn(state, step):
        if step == args.crash_at and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected failure (testing restart)")
        return train_step(state, pipe.batch_at(step))

    def on_metrics(step, metrics):
        losses.append(float(metrics["loss"]))
        if lead and step % args.log_every == 0:
            dt = time.time() - t0
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)

    state, stats = run_with_restarts(
        init_state=make_init, step_fn=step_fn, ckpt_root=args.ckpt_dir,
        total_steps=args.steps, ckpt_every=args.ckpt_every, heartbeat=hb,
        state_shardings=state_shardings, device=device, on_metrics=on_metrics)

    first = sum(losses[:10]) / max(len(losses[:10]), 1)
    last = sum(losses[-10:]) / max(len(losses[-10:]), 1)
    if lead:
        print(f"done: steps={args.steps} failures={stats.failures} "
              f"loss {first:.4f} -> {last:.4f} "
              f"({time.time() - t0:.1f}s)")
    return state


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
