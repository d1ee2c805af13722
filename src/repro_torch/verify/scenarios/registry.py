"""Scenario registry: parallelism axes as declarative, independently
registered units — mirroring the rule registry (``repro.core.rules``).

Each scenario declares *once* which mesh axis it verifies, how its graph
pair is built (aval construction + base/distributed trace functions), and a
one-line description (the CLI's ``--list``).  The shared trace / stamp /
spec-registration plumbing lives in :mod:`.harness`; registering a new
parallelism axis is a ~100-line module, not a hand-rolled builder.

Builders are plain functions ``fn(arch, cfg, plan, scen, ctx)`` over a
:class:`~repro.verify.scenarios.harness.BuildCtx` (stamping toggle + the
session's shared base-trace cache) returning a
:class:`~repro.verify.scenarios.harness.GraphPair`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..plan import PlanError


@dataclass(frozen=True)
class ScenarioSpec:
    """One registered scenario kind."""

    kind: str  # e.g. "tp-forward"
    axis: str  # mesh axis the scenario verifies
    builder: Callable  # fn(arch, cfg, plan, scen, ctx) -> GraphPair
    doc: str = ""  # one-line description (CLI --list)
    requires: str = ""  # applicability note (e.g. "MoE archs only")


class ScenarioRegistry:
    def __init__(self) -> None:
        self._by_kind: dict[str, ScenarioSpec] = {}

    # -- registration (decorator) ------------------------------------------
    def scenario(self, kind: str, axis: str, doc: str = "",
                 requires: str = ""):
        """Register ``fn(arch, cfg, plan, scen, ctx) -> GraphPair`` as the
        builder for scenario ``kind``."""

        def deco(fn: Callable) -> Callable:
            if kind in self._by_kind:
                raise ValueError(f"scenario {kind!r} registered twice")
            self._by_kind[kind] = ScenarioSpec(kind, axis, fn, doc, requires)
            return fn

        return deco

    # -- lookup ------------------------------------------------------------
    def get(self, kind: str) -> ScenarioSpec:
        spec = self._by_kind.get(kind)
        if spec is None:
            raise PlanError(
                f"unknown scenario kind {kind!r} "
                f"(registered: {', '.join(self.kinds())})")
        return spec

    def kinds(self) -> list[str]:
        return sorted(self._by_kind)

    def specs(self) -> list[ScenarioSpec]:
        return [self._by_kind[k] for k in self.kinds()]

    def describe(self) -> str:
        lines = []
        for s in self.specs():
            req = f"  [{s.requires}]" if s.requires else ""
            lines.append(f"{s.kind:16s} axis={s.axis:6s} {s.doc}{req}")
        return "\n".join(lines)


# The default registry, populated by the scenario modules imported from
# ``repro.verify.scenarios.__init__`` (tp, dp, pipeline, sp, ep, composite).
DEFAULT_SCENARIOS = ScenarioRegistry()
