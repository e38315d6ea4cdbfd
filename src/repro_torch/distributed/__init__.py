"""Training over a device mesh and its supervision: the name-based sharding
rules (``sharding``), int8 gradient compression (``compression``) and
checkpoint-restart (``fault_tolerance``)."""

from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              distribute, opt_state_shardings,
                                              param_shardings, param_specs,
                                              sanitize_spec, spec_for_path)
from repro_torch.distributed.compression import compressed_psum
from repro_torch.distributed.fault_tolerance import (Heartbeat, RestartStats,
                                                     run_with_restarts)

__all__ = ["batch_specs", "cache_specs", "compressed_psum", "distribute",
           "opt_state_shardings", "param_shardings", "param_specs",
           "sanitize_spec", "spec_for_path", "Heartbeat", "RestartStats",
           "run_with_restarts"]
