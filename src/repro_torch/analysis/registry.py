"""Lint-pass registry: baseline-free static checks as decorated units.

Mirrors the rule registry (``repro.core.rules.registry``): each pass is a
plain generator ``fn(ctx) -> Iterable[LintFinding]`` over a
:class:`LintContext`, registered under a stable name with a family
(``ir`` — single-graph well-formedness — or ``sharding`` — placement
semantics over the verified mesh axis) and a one-line doc the CLI
``--list`` output shows.  ``DEFAULT_LINTS`` is populated by importing
:mod:`repro.analysis.lints` (the same import-side-effect convention the
rule family modules use).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import cached_property
from typing import Callable, Iterable, Optional

from repro_torch.core.ir import Graph

from .report import LintReport, rank_findings


class LintError(ValueError):
    """Unknown lint pass name (CLI maps this to exit code 2)."""


@dataclass(frozen=True)
class LintPass:
    """One registered lint pass: a pure check plus its metadata."""

    name: str
    family: str  # "ir" | "sharding"
    fn: Callable  # fn(ctx) -> Iterable[LintFinding]
    doc: str = ""


class LintRegistry:
    """Named lint passes (mirrors the rule and injector registries)."""

    def __init__(self) -> None:
        self._by_name: dict[str, LintPass] = {}

    # -- registration (decorator) ------------------------------------------
    def lint(self, name: str, *, family: str, doc: str = ""):
        def deco(fn: Callable) -> Callable:
            if name in self._by_name:
                raise ValueError(f"lint pass {name!r} registered twice")
            self._by_name[name] = LintPass(name, family, fn, doc)
            return fn

        return deco

    # -- lookup ------------------------------------------------------------
    def get(self, name: str) -> LintPass:
        spec = self._by_name.get(name)
        if spec is None:
            raise LintError(
                f"unknown lint pass {name!r} "
                f"(registered: {', '.join(self.names())})")
        return spec

    def names(self) -> list[str]:
        return sorted(self._by_name)

    def specs(self) -> list[LintPass]:
        return [self._by_name[n] for n in self.names()]

    def resolve(self, names: Optional[Iterable[str]] = None) -> list[LintPass]:
        """The requested subset in registration-name order (None = all)."""
        if names is None:
            return self.specs()
        return [self.get(n) for n in names]

    def describe(self) -> str:
        lines = []
        for s in self.specs():
            lines.append(f"{s.name:22s} family={s.family:10s} {s.doc}")
        return "\n".join(lines)


# The default registry, populated by importing repro.analysis.lints.
DEFAULT_LINTS = LintRegistry()


@dataclass
class LintContext:
    """Everything a lint pass may read about one graph under lint.

    ``input_placements`` maps leaf node ids to abstract placement states
    (see :mod:`repro.analysis.placement`); ``output_placements`` carries the
    expected placement kind (``dup``/``shard``/``partial``) per graph
    output.  ``placement`` runs the abstract interpreter lazily and caches
    it — passes that only need IR structure never pay for it.
    """

    graph: Graph
    size: int = 1  # devices along the verified axis
    axis: str = "model"  # the verified mesh axis
    mesh_axes: tuple = ("model",)  # every axis the program's mesh declares
    input_placements: dict = field(default_factory=dict)
    output_placements: list = field(default_factory=list)
    arch: str = ""

    @cached_property
    def placement(self):
        from .placement import analyze_placements

        return analyze_placements(self)

    @cached_property
    def consumers(self) -> dict:
        return self.graph.consumer_index()


def run_lints(ctx: LintContext, passes: Optional[Iterable[str]] = None,
              registry: LintRegistry = DEFAULT_LINTS) -> LintReport:
    """Run the (subset of) registered passes over one graph."""
    t0 = time.perf_counter()
    specs = registry.resolve(list(passes) if passes is not None else None)
    findings = []
    for spec in specs:
        for f in spec.fn(ctx):
            f.arch = f.arch or ctx.arch
            f.graph = f.graph or ctx.graph.name
            findings.append(f)
    return LintReport(
        findings=rank_findings(findings),
        passes=[s.name for s in specs],
        units=[{"arch": ctx.arch, "graph": ctx.graph.name,
                "size": ctx.size, "axis": ctx.axis,
                "nodes": len(ctx.graph)}],
        elapsed_s=time.perf_counter() - t0)
