"""What several per-layer metrics share: the device time under a host op and
the roofline share of a kernel of the port.  Each metric's own file
(``metrics/<name>.py``) says what it reads; each returns None where the
run has nothing to read."""

from __future__ import annotations

from typing import Iterable, Optional

from perfbench.counts import peaks

AUTOGRAD = "autograd::engine::evaluate_function: "

#: the device kernels each wrapper of the port launches
KERNELS = {
    "flash_attention": ("attn_wgmma_kernel", "attn_tile_kernel", "attn_rows_kernel"),
    "ssd_chunk": ("ssd_chunk_kernel", "ssd_mma_kernel"),
    "kmeans_assign": ("kmeans_mma_kernel", "kmeans_assign_kernel", "kmeans_assign_dtiled",
                      "kmeans_sums_kernel", "kmeans_split_centers", "kmeans_reduce"),
}


def named(keys: Iterable[str]):
    keys = tuple(keys)
    return lambda name: any(k in name for k in keys)


def share_under_host(run, node: str) -> Optional[float]:
    """Device time under the host ops named ``node`` over the window's."""
    s = run.traced
    if s is None or s.device_s <= 0:
        return None
    return 100.0 * s.under_host(lambda n: n == node) / s.device_s


def roofline(run, wrapper: str, flop: float, nbytes: float, kind: str) -> Optional[float]:
    """The least time of the traced window's calls of ``wrapper`` (each of
    ``flop`` operations and ``nbytes`` bytes) over the device time of the
    kernels it launches."""
    s = run.traced
    if s is None:
        return None
    calls = s.counters.get(wrapper, 0)
    took = s.time_of(named(KERNELS[wrapper]))
    if calls <= 0 or took <= 0:
        return None
    return 100.0 * calls * peaks.least_time(flop, nbytes, kind) / took
