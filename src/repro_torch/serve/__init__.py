"""repro_torch.serve: low-latency predict serving over the plan layer (the
port of ``repro.serve``; it sits beside ``repro_torch.launch.serve``, the
zamba2 LM server).

The fit side of the estimator subsystem is throughput work; serving is
latency work.  This package closes the gap with four pieces, each leaning
on machinery the repo already has:

* :class:`ModelRegistry` (``registry``) — named + versioned fitted models,
  loaded from ``save_model`` files, fitted tensors pinned on the
  registry's device (``ModelRegistry(device="cuda")``, the default);
* :class:`~repro_torch.serve.compilecache.PredictCompileCache`
  (``compilecache``) — per-(model, geometry) warm-up of predict plans at
  model-load time (``Plan.compile_aot``: the run cached, and on the card
  run once, so kernels are built before any request), so steady-state
  serving replays warmed runs with zero re-optimizations;
* ``batching`` — request micro-batching into declared geometry buckets:
  payloads concatenate along the block-aligned batch dim, tails pad with
  zeros, results slice back per request (dense and BCOO, no densifying);
* :class:`PredictServer` (``server``) — submit/pump/serve_forever dispatch
  that routes plan launches through ``resilience.run_resilient``, degrades
  batched -> unbatched under injected ``serve_dispatch`` faults, and feeds
  the :func:`stats` counters + latency percentiles.

    reg = ModelRegistry(device="cuda")
    reg.register("ridge", fitted, batch_sizes=(1, 8, 32))
    srv = PredictServer(reg)
    fut = srv.submit("ridge", rows)      # (r, n_features) ndarray or scipy
    srv.pump()                           # or srv.start() for a thread
    y = fut.result()                     # (r, 1), exact vs direct predict
"""

from repro_torch.serve.batching import (BucketSpec, FORMAT_BCOO,
                                        FORMAT_DENSE, GeometryBucket)
from repro_torch.serve.compilecache import PredictCompileCache
from repro_torch.serve.registry import ModelRegistry, ServedModel
from repro_torch.serve.server import PredictFuture, PredictServer
from repro_torch.serve.stats import latency_summary, reset_stats, stats

__all__ = [
    "BucketSpec",
    "FORMAT_BCOO",
    "FORMAT_DENSE",
    "GeometryBucket",
    "ModelRegistry",
    "PredictCompileCache",
    "PredictFuture",
    "PredictServer",
    "ServedModel",
    "latency_summary",
    "reset_stats",
    "stats",
]
