"""The traced window: ``torch.profiler`` over a few items of the cell's work,
kept in memory and reduced to what the per-layer metrics read.

A :class:`Summary` holds the device operations (kernels, copies, sets) with
their intervals, the host ops that contain them (autograd nodes, ranges the
drivers place), the window's host-clock length, the busy time (the union of
the device intervals) and the kernel-launch counters the port keeps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from typing import Callable, Dict, List, Optional, Tuple

#: the range around the traced window; every range the harness places is
#: named ``perfbench.*``, and its own device-side span is not an operation
WINDOW = "perfbench.window"

#: the port's kernel wrappers and their counters
COUNTERS = {
    "flash_attention": ("repro_torch.kernels.flash_attention.kernel", "flash_attention"),
    "ssd_chunk": ("repro_torch.kernels.ssd.kernel", "ssd_chunk"),
    "kmeans_assign": ("repro_torch.kernels.kmeans.kernel", "kmeans_assign_stacked"),
}


def read_counters() -> Dict[str, int]:
    """{wrapper: launches so far} of the port's kernel wrappers."""
    out = {}
    for name, (mod, attr) in COUNTERS.items():
        out[name] = int(getattr(importlib.import_module(mod), attr).launches)
    return out


def counter_delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


@contextlib.contextmanager
def ranges(spec: Dict[str, Tuple[str, str]]):
    """Each function ``module.attr`` of ``spec`` {range name: (module,
    attr)} wrapped in a ``record_function`` range of that name."""
    from torch.profiler import record_function
    saved = []

    def ranged(name, real):
        def wrapper(*args, **kw):
            with record_function(name):
                return real(*args, **kw)
        return wrapper

    try:
        for name, (mod, attr) in spec.items():
            obj = importlib.import_module(mod)
            real = getattr(obj, attr)
            saved.append((obj, attr, real))
            setattr(obj, attr, ranged(name, real))
        yield
    finally:
        for obj, attr, real in saved:
            setattr(obj, attr, real)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float          # s, on the profiler's clock
    end: float


@dataclasses.dataclass
class Summary:
    ops: List[DeviceOp]
    host: List[Tuple[str, float, float, float]]   # (name, start, end, device s under it)
    cpu: List[Tuple[str, float, float]]           # every host op: (name, start, end)
    window_s: float
    counters: Dict[str, int]
    items: int

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        total, cur_lo, cur_hi = 0.0, None, None
        for op in sorted(self.ops, key=lambda o: o.start):
            if cur_hi is None or op.start > cur_hi:
                if cur_hi is not None:
                    total += cur_hi - cur_lo
                cur_lo, cur_hi = op.start, op.end
            else:
                cur_hi = max(cur_hi, op.end)
        if cur_hi is not None:
            total += cur_hi - cur_lo
        return total

    @property
    def device_s(self) -> float:
        """The sum of the device operations' times."""
        return sum(op.end - op.start for op in self.ops)

    def time_of(self, match: Callable[[str], bool]) -> float:
        return sum(op.end - op.start for op in self.ops if match(op.name))

    def under_host(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the kernels launched under host ops whose name
        matches (outermost matches only, so nothing counts twice)."""
        return sum(dev for name, _, _, dev in self.host if match(name))

    def gaps(self) -> List[Tuple[float, float]]:
        out, hi = [], None
        for op in sorted(self.ops, key=lambda o: o.start):
            if hi is not None and op.start > hi:
                out.append((hi, op.start))
            hi = op.end if hi is None else max(hi, op.end)
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.end - op.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        named = []
        for lo, hi in gaps:
            mid = 0.5 * (lo + hi)
            inner = [(s, n) for n, s, e in self.cpu if s <= mid <= e]
            what = max(inner)[1] if inner else "no host op"
            named.append([what[:120], hi - lo])
        return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": named}


def profile(fn: Callable[[], int], torch, host_names: Optional[Callable[[str], bool]] = None,
            range_spec: Optional[Dict[str, Tuple[str, str]]] = None) -> Summary:
    """Run ``fn`` (which returns the number of items it ran) under the
    profiler, synchronised at both ends; the window is the host-clock time
    between the two synchronisations.  ``host_names`` picks the host ops
    whose device time the metrics read (autograd nodes, ranges)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    before = read_counters()
    with ranges(range_spec or {}):
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            # a first kernel and a sync, so the trace is live before the window
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function(WINDOW):
                items = fn()
                torch.cuda.synchronize()
            window = time.perf_counter() - t0
    counters = counter_delta(before, read_counters())
    events = prof.events()
    mark = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not mark:
        raise RuntimeError("the profiler lost the window's range")
    first = mark[0].time_range.start
    ops = [DeviceOp(e.name, (e.time_range.start - first) * 1e-6,
                    (e.time_range.end - first) * 1e-6) for e in events
           if e.device_type == DeviceType.CUDA and not e.name.startswith("perfbench.")
           and e.time_range.start >= first]
    if not ops:
        raise RuntimeError("the profiler recorded no device time")
    host, cpu = [], []
    for e in events:
        if e.device_type != DeviceType.CPU or e.name == WINDOW:
            continue
        lo, hi = (e.time_range.start - first) * 1e-6, (e.time_range.end - first) * 1e-6
        cpu.append((e.name, lo, hi))
        if host_names is not None and host_names(e.name):
            parent = e.cpu_parent
            while parent is not None and not host_names(parent.name):
                parent = parent.cpu_parent
            if parent is None:
                host.append((e.name, lo, hi, e.device_time_total * 1e-6))
    return Summary(ops=ops, host=host, cpu=cpu, window_s=window,
                   counters=counters, items=items)
