"""A benchmark in miniature for the CPU tests: the real drivers, references
and metrics, with the real configurations shrunk to a few layers of small
width in float32 and the real mixes to a few short sequences, in a folder
of its own (with copies of the drivers and the metric readers).  The
limits are of this size and precision, not the card's."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

from perfbench import harness

HERE = Path(__file__).resolve().parent

SMALL = {
    "zamba2-2.7b": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
                        vocab_size=256, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
                        share_period=2, dtype="float32"),
    "mixtral-8x7b-4l": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                            vocab_size=256, n_experts=4, dtype="float32"),
}
MIXES = {
    "train-b2-t4096": dict(batch=2, seq=64),
    "train-b1-t8192": dict(batch=1, seq=64),
    "cluster-4x2x4096-k64": dict(batches=2, batch=2, seq=64, block_rows=64, clusters=8),
    "score-t8192": dict(batch=1, seq=128),
}
#: limits of the small cells on the CPU in float32: far above what sound
#: runs read there (1e-7 to 1e-4; param_gap to 2e-3: Adam steps of the
#: near-zero gradients), far below the controls and faults
LIMITS = {
    "zamba2-train": {"grad_norm_gap": 1e-3, "grad_leaf_gap": 1e-3, "delta_leaf_gap": 1e-3,
                     "param_gap": 1e-2},
    "mixtral-train": {"grad_norm_gap": 1e-3, "grad_leaf_gap": 1e-3,
                      "delta_leaf_gap": 1e-3, "param_gap": 1e-2, "route_margin": 1e-3,
                      "drop_gap": 0.0},
    "zamba2-cluster": {"hidden_gap": 1e-4, "center_gap": 1e-5, "inertia_gap": 1e-6,
                       "stop_gap": 1.0},
    "mixtral-score": {"score_loss_gap": 1e-4, "route_margin": 1e-3, "drop_gap": 0.0},
}


def build(root: Path) -> harness.Bench:
    """The miniature benchmark under ``root``; returns it loaded."""
    man = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    (root / "perfbench").mkdir(parents=True, exist_ok=True)
    for kind in ("configs", "traffic", "limits"):
        (root / "perfbench" / kind).mkdir(exist_ok=True)
    for c in man["configs"]:
        body = json.loads((HERE.parent / c["file"]).read_text())
        body["model"].update(SMALL[c["name"]])
        (root / c["file"]).write_text(json.dumps(body))
    for w in man["workloads"]:
        mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        mix.update(MIXES[w["traffic"]])
        (root / "perfbench" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
        (root / "perfbench" / "limits" / f"{w['name']}.json").write_text(
            json.dumps(LIMITS[w["name"]]))
    for kind in ("drivers", "metrics"):
        shutil.copytree(HERE / kind, root / "perfbench" / kind, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return harness.Bench.load(root, root / "perfbench")


def run_cell(bench: harness.Bench, cell: str, seed: int = 7, fault=None,
             seconds: float = 0.3) -> dict:
    """One run of ``cell`` on the CPU, its look for a card skipped."""
    return harness.execute(bench.cell(cell), seed, seconds, False,
                           torch.device("cpu"), time.perf_counter(), fault=fault)


