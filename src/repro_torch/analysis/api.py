"""``analysis.check`` — the one entry point the tests, the CLI and user
code all call."""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.analysis.findings import Report, split_suppressed
from repro_torch.analysis.graph import PlanView
from repro_torch.analysis.liveness import LivenessReport, analyze
from repro_torch.analysis.rules import get_rules


def check(target, rules: Optional[Sequence[str]] = None,
          fail_on: str = "error",
          suppress: Sequence[str] = ()) -> Report:
    """Run the registered lint rules over a plan (or anything coercible to
    one: a ``Plan``, a lazy array/scalar, an ``Expr``, a ``DsArray``, or a
    sequence of those → one multi-root plan).

    ``rules`` selects rule ids (default: all).  ``fail_on`` sets the
    severity at which ``Report.ok`` flips false ("info" | "warn" |
    "error").  ``suppress`` entries waive a whole rule id or one finding
    token (``"rule@site"``).
    """
    view = PlanView.of(target)
    findings = []
    for rule in get_rules(rules):
        findings.extend(rule.run(view))
    live, quiet = split_suppressed(findings, suppress)
    return Report(live, quiet, fail_on=fail_on)


def liveness_report(target) -> LivenessReport:
    """Naive-vs-minimized peak HBM bytes for one plan (the data behind the
    ``peak-hbm-liveness`` rule, as a structured object)."""
    return analyze(PlanView.of(target).roots)
