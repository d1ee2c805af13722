"""Lint findings and the schema-versioned lint report.

A :class:`LintFinding` is one static-check hit: the registered pass that
fired, an ``error``/``warning`` severity (errors fail the lint gate, exit
code 1; warnings are reported but pass), the diagnostic *category* shared
with the relational verifier's vocabulary (``repro.core.report.SEVERITY``)
so lint and verify findings rank on one scale, and the faulty node's
id/op/source location for localization.

:class:`LintReport` aggregates findings across one or more linted graphs
("units" — e.g. one per scenario of a plan, or one per arch in a CLI
sweep), ranks them most-severe-first, and serializes to schema-versioned
JSON mirroring :class:`repro.core.report.Report`.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional

from repro_torch.core.report import severity_of

LINT_SCHEMA_VERSION = 1

ERROR = "error"
WARNING = "warning"
_LEVEL_ORDER = {ERROR: 0, WARNING: 1}
_CATEGORY_ORDER = {"high": 0, "medium": 1, "low": 2}


@dataclass
class LintFinding:
    """One static-check hit, localized to a node of the linted graph."""

    pass_name: str
    severity: str  # error | warning
    category: str  # diagnostic category (repro.core.report.SEVERITY keys)
    node: int
    op: str
    src: str
    detail: str
    # which linted unit the finding belongs to (set by the runner)
    arch: str = ""
    graph: str = ""

    @property
    def rank(self) -> tuple:
        return (_LEVEL_ORDER.get(self.severity, 1),
                _CATEGORY_ORDER.get(severity_of(self.category), 1))

    def line(self) -> str:
        where = f"{self.arch}:" if self.arch else ""
        return (f"[{self.severity}] {self.pass_name}: {self.category} at "
                f"{where}%{self.node} {self.op} ({self.src or '?'}) — "
                f"{self.detail}")


def rank_findings(findings: list) -> list:
    """Severity-ranked order (stable within a severity class)."""
    return sorted(findings, key=lambda f: f.rank)


@dataclass
class LintReport:
    """Schema-versioned result of a lint run over one or more graphs."""

    findings: list = field(default_factory=list)  # LintFinding, ranked
    passes: list = field(default_factory=list)  # pass names that ran
    units: list = field(default_factory=list)  # [{arch, graph, size, nodes}]
    elapsed_s: float = 0.0

    @property
    def errors(self) -> int:
        return sum(1 for f in self.findings if f.severity == ERROR)

    @property
    def warnings(self) -> int:
        return sum(1 for f in self.findings if f.severity == WARNING)

    @property
    def ok(self) -> bool:
        """The lint gate: no error-severity findings (warnings pass)."""
        return self.errors == 0

    def merge(self, other: "LintReport") -> "LintReport":
        """Fold another report in (multi-arch / multi-scenario sweeps)."""
        self.findings = rank_findings(self.findings + other.findings)
        self.passes = sorted(set(self.passes) | set(other.passes))
        self.units.extend(other.units)
        self.elapsed_s += other.elapsed_s
        return self

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema": LINT_SCHEMA_VERSION,
            "ok": self.ok,
            "errors": self.errors,
            "warnings": self.warnings,
            "passes": list(self.passes),
            "units": list(self.units),
            "findings": [asdict(f) for f in self.findings],
            "elapsed_s": self.elapsed_s,
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "LintReport":
        d = json.loads(s)
        if d.get("schema") != LINT_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported lint schema {d.get('schema')!r} "
                f"(expected {LINT_SCHEMA_VERSION})")
        rep = cls(passes=list(d.get("passes", ())),
                  units=list(d.get("units", ())),
                  elapsed_s=d.get("elapsed_s", 0.0))
        rep.findings = rank_findings(
            [LintFinding(**f) for f in d.get("findings", ())])
        return rep

    # -- human summary -----------------------------------------------------
    def summary(self, max_findings: int = 20) -> str:
        nodes = sum(u.get("nodes", 0) for u in self.units)
        head = (f"LINT {'OK' if self.ok else 'FAILED'}: "
                f"{self.errors} errors, {self.warnings} warnings "
                f"({len(self.units)} graphs, {nodes} nodes, "
                f"{len(self.passes)} passes, {self.elapsed_s:.2f}s)")
        lines = [head]
        for f in self.findings[:max_findings]:
            lines.append("  " + f.line())
        if len(self.findings) > max_findings:
            lines.append(f"  ... {len(self.findings) - max_findings} more")
        return "\n".join(lines)
