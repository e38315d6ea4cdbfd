"""Readings for a cell's limits, on the card at the cell's own size: for
each seed the sound program's numbers against the reference, the
control's (the reference in the next precision below the configuration's)
and each planted fault's.  Not part of a benchmark run.

    python3 perfbench/control.py --workload zamba2-train --seeds 11 12 13 \
        [--sides control_fp8 fault_half_batch]
"""

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    os.environ["USE_FLAX"] = "0"
    # three references one after another free and allocate leaves of many sizes
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import argparse

    import torch
    from perfbench import harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sides", nargs="*", default=None,
                    help="the controls and faults to read (all by default)")
    args = ap.parse_args()
    bench = harness.Bench.load()
    cell = bench.cell(args.workload)
    harness.device_check(torch, int(cell.workload["chips"]))
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                          device=device, t_start=t0)
        run.model_cfg = harness.model_config(cell.config)
        got = cell.driver.control(run, args.sides)
        print(got.pop("detail"), file=sys.stderr)
        got.pop("raw", None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **got}), flush=True)
        torch.cuda.empty_cache()
