"""Fault-tolerant training supervision, the port of
``repro.distributed.fault_tolerance``: checkpoint-restart, heartbeats,
deterministic resume.

* ``Heartbeat`` — a per-step timestamp file an external supervisor watches
  to detect hangs and stragglers.
* ``run_with_restarts`` — drives a step function, checkpoints every
  ``ckpt_every`` steps (async, ``checkpoint.AsyncCheckpointer``), and on
  failure restores the newest committed checkpoint and continues, up to
  ``max_failures``, with exponential backoff between restarts.  Errors are
  classified first (``resilience.execute.classify_error``): a
  *deterministic* failure — NaN loss, shape bug, a kernel that fails to
  build — raises at once instead of burning every restart on the same
  crash; unknown exceptions default to *transient*.  The data pipeline
  needs no replay: batch ``i`` is a pure function of ``i``.

A restored leaf lands on ``device``, or, with ``state_shardings`` (a tree
of ``distributed.sharding.Sharding`` like the state's, the reference's
argument), on its mesh as a DTensor, whatever mesh saved it; each is cast
to its ``init_state()`` proto's dtype (a bf16 state restores bit for bit).
Over a mesh every rank runs the loop (SPMD); the checkpointer gathers the
state on every rank and rank 0 writes it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.checkpoint import checkpoint as ckpt


class Heartbeat:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int, **info) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time(), **info}, f)
        os.replace(tmp, self.path)

    def age(self) -> Optional[float]:
        try:
            with open(self.path) as f:
                return time.time() - json.load(f)["time"]
        except (OSError, ValueError):
            return None


@dataclasses.dataclass
class RestartStats:
    failures: int = 0
    restarts_at: tuple = ()


def run_with_restarts(
    *,
    init_state: Callable[[], Any],
    step_fn: Callable[[Any, int], Tuple[Any, Dict[str, float]]],
    ckpt_root: str,
    total_steps: int,
    ckpt_every: int = 50,
    max_failures: int = 3,
    heartbeat: Optional[Heartbeat] = None,
    state_shardings: Optional[Any] = None,
    device="cuda",
    on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None,
    backoff: float = 0.0,
    backoff_factor: float = 2.0,
    max_backoff: float = 30.0,
) -> Tuple[Any, RestartStats]:
    """Generic supervised train loop (``launch/train.py`` is the LM driver).

    ``step_fn(state, step)`` must be deterministic given (state, step) — the
    synthetic pipeline guarantees the data side of that contract.

    ``backoff`` > 0 sleeps before each restart, doubling (``backoff_factor``)
    per consecutive failure up to ``max_backoff``.
    """
    from repro_torch.resilience import execute as _resil

    saver = ckpt.AsyncCheckpointer(ckpt_root)
    stats = RestartStats()

    def restore_or_init():
        last = ckpt.latest_step(ckpt_root)
        if last is None:
            return init_state(), 0
        state = ckpt.restore(ckpt_root, last, init_state(), state_shardings,
                             device=device, allow_cast=True)
        return state, last + 1

    state, step = restore_or_init()
    while step < total_steps:
        try:
            state, metrics = step_fn(state, step)
            if heartbeat is not None:
                heartbeat.beat(step, **{k: float(v) for k, v in metrics.items()})
            if on_metrics is not None:
                on_metrics(step, metrics)
            if (step + 1) % ckpt_every == 0 or step + 1 == total_steps:
                saver.save(step, state, extra={"metrics": {
                    k: float(v) for k, v in metrics.items()}})
            step += 1
        except Exception as exc:                             # noqa: BLE001
            # unknowns default to transient here: a real step touches
            # devices, disks and hosts, so only provably deterministic
            # failures (NaN loss, shape bugs) skip the restart machinery
            kind = _resil.classify_error(exc, default=_resil.TRANSIENT)
            if kind == _resil.DETERMINISTIC:
                saver.wait()
                raise
            stats.failures += 1
            stats.restarts_at = stats.restarts_at + (step,)
            if stats.failures > max_failures:
                saver.wait()
                raise
            if backoff > 0.0:
                time.sleep(min(
                    backoff * backoff_factor ** (stats.failures - 1),
                    max_backoff))
            saver.wait()
            state, step = restore_or_init()
    saver.wait()
    return state, stats
