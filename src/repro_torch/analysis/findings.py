"""Structured findings for the plan/jaxpr static analyzer.

A :class:`Finding` is one rule hit: the rule id, a severity, the site (a
plan-node label or an HLO/jaxpr description), a human message, and a stable
``token`` used for suppression.  Tokens are deterministic functions of the
rule id + site, so a waiver written against one run keeps matching as long
as the underlying plan structure is unchanged — the analyzer's analogue of
a ``# noqa: <code>`` comment for graphs that have no source lines.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

#: severity ladder; ``fail_on`` thresholds compare by this order.
SEVERITIES: Tuple[str, ...] = ("info", "warn", "error")


def severity_rank(severity: str) -> int:
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        raise ValueError(f"unknown severity {severity!r}; "
                         f"expected one of {SEVERITIES}")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation (or report) at one site."""

    rule: str            # stable rule id, e.g. "no-densify"
    severity: str        # "info" | "warn" | "error"
    site: str            # node label / eqn primitive / HLO line
    message: str
    data: tuple = ()     # optional structured payload (hashable)

    @property
    def token(self) -> str:
        """Suppression token: pass it to ``check(..., suppress=[token])``
        (or a bare rule id to waive the whole rule)."""
        return f"{self.rule}@{self.site}"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"[{self.severity}] {self.rule} @ {self.site}: {self.message}"


class Report:
    """The result of one ``analysis.check`` run.

    ``findings`` are the live (unsuppressed) findings; ``suppressed`` the
    waived ones.  ``ok`` is evaluated against the ``fail_on`` severity the
    check ran with: any live finding at or above it fails the report.
    """

    def __init__(self, findings: Sequence[Finding],
                 suppressed: Sequence[Finding] = (),
                 fail_on: str = "error"):
        self.findings: List[Finding] = list(findings)
        self.suppressed: List[Finding] = list(suppressed)
        self.fail_on = fail_on
        severity_rank(fail_on)   # validate eagerly

    def by_rule(self, rule_id: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule_id]

    @property
    def failing(self) -> List[Finding]:
        floor = severity_rank(self.fail_on)
        return [f for f in self.findings
                if severity_rank(f.severity) >= floor]

    @property
    def ok(self) -> bool:
        return not self.failing

    def raise_if_failed(self) -> "Report":
        if not self.ok:
            raise AnalysisError(self)
        return self

    def render(self) -> str:
        lines = []
        for f in self.findings:
            lines.append(str(f))
        for f in self.suppressed:
            lines.append(f"[suppressed] {f.rule} @ {f.site}: {f.message}")
        return "\n".join(lines) if lines else "(no findings)"

    def __iter__(self):
        return iter(self.findings)

    def __len__(self) -> int:
        return len(self.findings)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"Report(findings={len(self.findings)}, "
                f"suppressed={len(self.suppressed)}, ok={self.ok})")


class AnalysisError(AssertionError):
    """Raised by ``Report.raise_if_failed`` — an AssertionError so test
    helpers built on the analyzer read as plain assertion failures."""

    def __init__(self, report: Report):
        self.report = report
        super().__init__("static analysis failed:\n" + report.render())


def split_suppressed(findings: Iterable[Finding],
                     suppress: Sequence[str]) -> Tuple[List[Finding],
                                                       List[Finding]]:
    """Partition findings into (live, suppressed).  A suppression entry
    matches a whole rule (``"no-densify"``) or one site token
    (``"no-densify@Blockwise[map]#3"``)."""
    sset = set(suppress)
    live, quiet = [], []
    for f in findings:
        (quiet if (f.rule in sset or f.token in sset) else live).append(f)
    return live, quiet
