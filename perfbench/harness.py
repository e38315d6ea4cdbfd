"""The benchmark's harness: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name.  A cell of ``BENCHMARK.json``'s ``workloads``
names a configuration (``configs/<name>.json``: the port's ``ModelConfig``
and the sizes of the draw) and a traffic mix (``traffic/<name>.json``: the
mix's parameters and the ``driver`` that runs it, ``drivers/<driver>.py``).
The cell's limits are in ``limits/<cell>.json``; each per-layer metric is
read by ``metrics/<metric>.py``, or by the reader its name begins with
(``metrics/mfu.py`` reads ``mfu.train`` and ``mfu.score``).  A new cell,
configuration, mix or metric is a new file and a new entry: nothing here
changes.

A run: set-up (weights, inputs, warm-up, the first steps the reference
follows), the measured window, in a ``--trace 1`` run a traced window
after it, then the check against the plain reference under ``reference/``.
The last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


# ---------------------------------------------------------------------------
# Finding things by name
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Bench:
    """The manifest and the folder its files are found in."""
    manifest: dict
    folder: Path

    @classmethod
    def load(cls, root: Path = ROOT, folder: Path = HERE) -> "Bench":
        path = root / "BENCHMARK.json"
        if not path.exists():
            raise BenchError(f"no BENCHMARK.json in {root}")
        return cls(json.loads(path.read_text()), folder)

    def entry(self, key: str, name: str) -> dict:
        for e in self.manifest[key]:
            if e["name"] == name:
                return e
        raise BenchError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def json_file(self, kind: str, name: str) -> dict:
        path = self.folder / kind / f"{name}.json"
        if not path.exists():
            raise BenchError(f"no {kind} file {path.name}")
        return json.loads(path.read_text())

    def config(self, name: str) -> dict:
        entry = self.entry("configs", name)
        return json.loads((self.folder.parent / entry["file"]).read_text())

    def module(self, kind: str, name: str):
        """``<folder>/<kind>/<name>.py``, else the reader its name begins
        with (``metrics/mfu.py`` for ``mfu.train``), loaded from its path:
        a metric's name may hold dots."""
        path = self.folder / kind / f"{name}.py"
        if not path.exists():
            path = self.folder / kind / f"{name.split('.')[0]}.py"
        if not path.exists():
            raise BenchError(f"no {kind} module {name}.py")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name: str) -> "Cell":
        w = self.entry("workloads", name)
        limits = self.json_file("limits", name)
        return Cell(name=name, workload=w, config=self.config(w["config"]),
                    traffic=self.json_file("traffic", w["traffic"]),
                    limits=limits, bench=self)

    def metrics_of(self, kind: str, cell: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports:
        those that list it, and those with no list whose ``moves`` (or, end
        to end, whose own name) the cell reports."""
        e2e_here = [m["name"] for m in self.manifest["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        out = []
        for m in self.manifest[kind]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e_here:
                out.append(m)
        return out


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    bench: Bench

    @property
    def driver(self):
        return self.bench.module("drivers", self.traffic["driver"])


# ---------------------------------------------------------------------------
# Seeds
# ---------------------------------------------------------------------------


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for the draw ``tags`` of run ``seed`` (any whole number,
    of any size)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             int(seed) < 0, *(int(t) % 2 ** 64 for t in tags)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    """What a driver gets and fills in."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    model_cfg: Any = None
    setup_s: Optional[float] = None
    attempted: int = 0
    failed: int = 0
    window: Dict[str, Any] = dataclasses.field(default_factory=dict)
    traced: Any = None             # trace.Summary of the traced window
    compared: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fault: Optional[str] = None    # a fault planted by the fault test

    def mark_setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start

    def compare(self, name: str, value: float) -> None:
        """Record one number beside its limit from the cell's limits file; a
        number the file gives no limit is kept as a reading, not compared."""
        if name not in self.cell.limits:
            self.notes.setdefault("readings", {})[name] = float(value)
            return
        self.compared[name] = {"value": float(value),
                               "limit": float(self.cell.limits[name])}

    @property
    def correct(self) -> bool:
        return bool(self.compared) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.compared.values())


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**cfg["model"])


def forbidden_loaded() -> List[str]:
    """Modules of ``sys.modules`` whose top-level name is JAX's, Flax's or
    the JAX package's (``repro``; ``repro_torch`` is another name)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_check(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} present")


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except Exception as e:  # noqa: BLE001 - a note, not a result
        return f"not read ({type(e).__name__})"


def read_metrics(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = run.cell.bench.module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = run.setup_s if m["name"] == "setup_s" else run.window.get(m["name"])
        if value is None:
            raise BenchError(f"the window gave no {m['name']}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, fault: Optional[str] = None) -> dict:
    """Run ``cell`` once; returns the result object (the last line)."""
    import torch
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
              t_start=t_start, fault=fault)
    run.model_cfg = model_config(cell.config)
    cell.driver.run(run)
    bench = cell.bench
    metrics = (read_metrics(run, bench.metrics_of("per_layer", cell.name)) if trace
               else end_to_end(run, bench.metrics_of("end_to_end", cell.name)))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
           else "cpu", "count": 1,
           "memory_peak_bytes": int(run.window.get("memory_peak_bytes", 0))}
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.traced is not None:
        dev["busy_s"] = run.traced.busy_s
        dev["window_s"] = run.traced.window_s
        result["breakdown"] = run.traced.breakdown()
    result["compared"] = run.compared
    if run.notes.get("detail"):
        print(run.notes["detail"], file=sys.stderr)
    if run.notes.get("readings"):
        print(f"not compared: {json.dumps(run.notes['readings'])}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    try:
        bench = Bench.load()
        cell = bench.cell(args.workload)
        import torch
        device_check(torch, int(cell.workload["chips"]))
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        result = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                         t_start)
        found = forbidden_loaded()
        if found:
            raise BenchError(f"modules of JAX or the JAX package were loaded: {found}")
    except BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr, flush=True)
        return 2
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
