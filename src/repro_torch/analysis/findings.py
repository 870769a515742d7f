"""Finding/Report containers shared by every checker of the port's analysis
plane (a copy of ``src/repro/analysis/findings.py``: the same JSON keys
and rendered lines, so the two reports read alike).

A ``Finding`` is one named defect (or informational note) attached to a
subject — a kernel entry, a plan variant, or a generator family.  Checkers
return lists of findings; ``Report`` aggregates them, renders the human
summary, and serializes the machine-readable JSON that CI uploads as an
artifact.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

# Severity ladder.  ``error`` fails --strict; ``warning`` is reported but
# does not gate; ``info`` is catalog bookkeeping (counts, coverage).
SEVERITIES = ("error", "warning", "info")

SCHEMA_VERSION = 1


@dataclass(frozen=True)
class Finding:
    """One named analysis result.

    checker:  short machine name of the rule that fired, e.g.
              ``write-race`` or ``host-sync-over-budget``.
    severity: one of ``SEVERITIES``.
    subject:  what was analyzed, e.g. ``kernel:counter_scatter[b=32,n=64]``
              or ``plan:trim/ac4[probe=dense,frontier=sparse]``.
    message:  human-readable detail, including the concrete witness
              (grid points, eqn primitive, kwarg name) when one exists.
    """

    checker: str
    severity: str
    subject: str
    message: str

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def render(self) -> str:
        return f"[{self.severity}] {self.checker} :: {self.subject}: {self.message}"


@dataclass
class Report:
    """Aggregate of findings across checkers, plus subject coverage counts."""

    findings: list[Finding] = field(default_factory=list)
    subjects_checked: dict[str, int] = field(default_factory=dict)

    def extend(self, findings: list[Finding]) -> None:
        self.findings.extend(findings)

    def note_subjects(self, checker: str, count: int) -> None:
        self.subjects_checked[checker] = self.subjects_checked.get(checker, 0) + count

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def ok(self, strict: bool = False) -> bool:
        if strict:
            return not self.errors and not self.warnings
        return not self.errors

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def to_json(self) -> dict:
        return {
            "version": SCHEMA_VERSION,
            "counts": self.counts(),
            "subjects_checked": dict(self.subjects_checked),
            "findings": [
                {
                    "checker": f.checker,
                    "severity": f.severity,
                    "subject": f.subject,
                    "message": f.message,
                }
                for f in self.findings
            ],
        }

    def dump_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)
            fh.write("\n")

    def render(self, verbose: bool = False) -> str:
        lines: list[str] = []
        shown = self.findings if verbose else [
            f for f in self.findings if f.severity != "info"
        ]
        for f in shown:
            lines.append(f.render())
        c = self.counts()
        checked = sum(self.subjects_checked.values())
        lines.append(
            f"analysis: {checked} subjects checked across "
            f"{len(self.subjects_checked)} checkers — "
            f"{c['error']} error(s), {c['warning']} warning(s), {c['info']} info"
        )
        return "\n".join(lines)
