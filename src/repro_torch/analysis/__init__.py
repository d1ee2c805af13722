"""Baseline-free static analysis tier: single-graph lints + registry checks.

Public surface:

* :func:`run_lints` / :data:`DEFAULT_LINTS` — run registered lint passes
  over a :class:`LintContext` (one graph + its placement seed).
* :func:`trace_lint_unit` — trace ONE graph (no baseline pair) for an arch
  at a parallelism degree, ready to lint.
* :class:`LintReport` / :class:`LintFinding` — severity-ranked,
  schema-versioned results.
* :func:`check_registry` — the rule-registry producer/consumer matrix
  checker (dead rules, orphan kinds, declaration drift, op coverage).
"""
from . import lints as _lints  # noqa: F401  (registers the default passes)
from .placement import analyze_placements
from .registry import (DEFAULT_LINTS, LintContext, LintError, LintPass,
                       LintRegistry, run_lints)
from .report import (ERROR, LINT_SCHEMA_VERSION, WARNING, LintFinding,
                     LintReport, rank_findings)
from .rulecheck import RulecheckReport, check_registry, trace_ops
from .single import LintUnit, pair_lint_unit, trace_lint_unit, unit_context

__all__ = [
    "DEFAULT_LINTS", "ERROR", "LINT_SCHEMA_VERSION", "LintContext",
    "LintError", "LintFinding", "LintPass", "LintRegistry", "LintReport",
    "LintUnit", "RulecheckReport", "WARNING", "analyze_placements",
    "check_registry", "pair_lint_unit", "rank_findings", "run_lints",
    "trace_lint_unit", "trace_ops", "unit_context",
]
