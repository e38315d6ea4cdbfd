"""Training supervision.  The mesh half of the reference's package
(``sharding``, ``compression``) is not ported yet (ROADMAP.md §1 item
13.1b)."""

from repro_torch.distributed.fault_tolerance import (Heartbeat, RestartStats,
                                                     run_with_restarts)

__all__ = ["Heartbeat", "RestartStats", "run_with_restarts"]
