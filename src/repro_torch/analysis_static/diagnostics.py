"""Lint diagnostics: findings, severities, and the raise convention.

Every planlint rule reports through a ``LintFinding`` carrying a rule
id, a severity, and a plan location, and every exception a pass raises
embeds ``[planlint:<rule-id>]`` in its message — so runtime rejections
(``FoldError``, the construction-time gate) and CLI output name the
SAME rule, and a test can pin an error to its rule id by substring.
The format is the JAX package's (``repro.analysis_static``), so a
finding reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Type

SEVERITIES = ("error", "warning", "info")


class PlanLintError(ValueError):
    """A lint pass found an error-severity violation.

    A ``ValueError`` so callers of the guards planlint replaced
    (``lowering.check_extension_prefix``, fold validation) keep catching
    it without change.
    """


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One diagnostic: ``[planlint:<rule>] <location>: <message>``."""
    rule: str
    message: str
    severity: str = "error"
    location: str = ""            # plan location, e.g. "scan[item]"

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def format(self) -> str:
        where = f" {self.location}:" if self.location else ""
        return f"[planlint:{self.rule}]{where} {self.message}"


def errors_in(findings: Iterable[LintFinding]) -> List[LintFinding]:
    return [f for f in findings if f.severity == "error"]


def format_findings(findings: Iterable[LintFinding]) -> str:
    return "\n".join(f.format() for f in findings)


def raise_on_error(findings: Iterable[LintFinding],
                   exc: Type[Exception] = PlanLintError
                   ) -> List[LintFinding]:
    """Raise ``exc`` if any finding is error-severity; else pass the
    findings through (so always-on call sites stay one-liners)."""
    findings = list(findings)
    errs = errors_in(findings)
    if errs:
        raise exc(format_findings(errs))
    return findings
