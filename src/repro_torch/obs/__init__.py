"""Telemetry for the port: a counter registry and trace spans."""

from repro_torch.obs import metrics, tracing
from repro_torch.obs.metrics import registry
from repro_torch.obs.tracing import span

__all__ = ["metrics", "tracing", "registry", "span"]
