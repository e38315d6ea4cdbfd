"""End-to-end training driver (fault-tolerant), the port of
``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --smoke --device cpu --steps 200 --batch 8 --seq 128 --ckpt-dir CKPT
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --steps 100 --batch 2 --seq 4096           # on the card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-medium --batch 4 --seq 1024   # 1,024 frames, 1,024 tokens

One card, or the CPU when ``--device cpu`` names it.  Features: the
deterministic synthetic pipeline, AdamW + cosine, per-group remat, async
checkpointing, automatic resume, heartbeat, optional crash injection to
exercise the restart path.  ``--mesh`` (training over a device mesh) is not
ported yet.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.dsarray import resolve_device
from repro_torch.data.pipeline import pipeline_for_model
from repro_torch.distributed.fault_tolerance import Heartbeat, run_with_restarts
from repro_torch.models.model import build_model
from repro_torch.optim import make_optimizer
from repro_torch.train.step import init_state, make_train_step


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
    ap.add_argument("--mesh", default="", help="e.g. data=2,model=2 (not "
                                               "ported yet)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="inject a failure at this step (tests restart)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(
            "--mesh: training over a device mesh is not ported to repro_torch "
            "yet (ROADMAP.md §1 item 13.1b)")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    pipe = pipeline_for_model(cfg, args.batch, args.seq, device=device)
    opt = make_optimizer(args.optimizer, peak_lr=args.lr, warmup=10,
                         total=args.steps)
    train_step = make_train_step(model, opt, accum_steps=args.accum_steps)

    def make_init():
        return init_state(model, opt, torch.Generator(device).manual_seed(0),
                          device)

    hb = Heartbeat(os.path.join(args.ckpt_dir, "heartbeat.json"))
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
        if step % args.log_every == 0:
            dt = time.time() - t0
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)

    state, stats = run_with_restarts(
        init_state=make_init, step_fn=step_fn, ckpt_root=args.ckpt_dir,
        total_steps=args.steps, ckpt_every=args.ckpt_every, heartbeat=hb,
        device=device, on_metrics=on_metrics)

    first = sum(losses[:10]) / max(len(losses[:10]), 1)
    last = sum(losses[-10:]) / max(len(losses[-10:]), 1)
    print(f"done: steps={args.steps} failures={stats.failures} "
          f"loss {first:.4f} -> {last:.4f} "
          f"({time.time() - t0:.1f}s)")
    return state


if __name__ == "__main__":
    main()
