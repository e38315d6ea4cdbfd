"""Static analysis of lazy ds-array plans (the part of ``repro.analysis``
ported so far): :mod:`repro_torch.analysis.liveness`, the peak device
memory of a plan under its emission order and under a liveness-minimising
order, from the ``costmodel`` byte laws.  The lint rules, the CLI and the
graph plane wait for their port."""

from repro_torch.analysis import liveness
from repro_torch.analysis.liveness import (LivenessReport, analyze,
                                           minimized_order, node_output_bytes,
                                           simulate_peak)

__all__ = ["LivenessReport", "analyze", "liveness", "minimized_order",
           "node_output_bytes", "simulate_peak"]
