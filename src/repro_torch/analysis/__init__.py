"""Static analysis for lazy ds-array plans and the ops their runs dispatch
(the port of ``repro.analysis``).

Inspection planes over one :func:`check` entry point:

* **plan plane** — lint rules over the recorded ``Expr`` DAG, before and
  after ``core.plan`` optimization (densify discipline, pad soundness,
  cache-key stability, peak device-memory liveness ordering);
* **graph plane** — rules over the ops of one run of the plan
  (``Plan.graph()``, :mod:`repro_torch.analysis.graphs`: select-pass
  budgets, densified sparse operands, full-grid intermediates), the port's
  counterpart of the reference's jaxpr and HLO planes;
* **profile plane** — measured against predicted bytes per node.

>>> from repro_torch import analysis
>>> analysis.check(plan_or_dsarray).raise_if_failed()

``python -m repro_torch.analysis`` lints the plans behind the examples and
estimator fits (see ``__main__``).
"""

from repro_torch.analysis import liveness
from repro_torch.analysis.api import check, liveness_report
from repro_torch.analysis.findings import (AnalysisError, Finding, Report,
                                           SEVERITIES, severity_rank)
from repro_torch.analysis.graph import PlanView
from repro_torch.analysis.graphs import (Graph, OpNode,
                                         assert_fused_single_body,
                                         assert_no_densify,
                                         assert_no_global_intermediate,
                                         count_selects,
                                         dense_operand_intermediates,
                                         full_grid_writes, primitives,
                                         rank2_global_intermediates,
                                         trace_ops, walk)
from repro_torch.analysis.liveness import (LivenessReport, analyze,
                                           minimized_order, node_output_bytes,
                                           simulate_peak)
from repro_torch.analysis.rules import Rule, all_rule_ids, get_rules, register

__all__ = [
    "check", "liveness_report",
    "AnalysisError", "Finding", "Report", "SEVERITIES", "severity_rank",
    "PlanView",
    "Graph", "OpNode", "assert_fused_single_body", "assert_no_densify",
    "assert_no_global_intermediate", "count_selects",
    "dense_operand_intermediates", "full_grid_writes", "primitives",
    "rank2_global_intermediates", "trace_ops", "walk",
    "LivenessReport", "analyze", "liveness", "minimized_order",
    "node_output_bytes", "simulate_peak",
    "Rule", "all_rule_ids", "get_rules", "register",
]
