"""Rule registry: op-family rules as declarative, independently-registered
units (the paper's ~25 polymorphic meta rules over op families, §5.2.2).

Each rule is a plain function ``fn(prop, node)`` over the
:class:`~repro.core.rules.propagator.Propagator` context.  A rule declares

* ``ops``      — the distributed-graph op names it fires on (empty for the
  fallback rule, which fires on any op without explicit rules), and
* ``consumes`` — the fact kinds it reads from the node's *inputs*.  The
  semi-naive worklist engine uses this to skip re-firing a rule when the
  newly-derived facts on a node's inputs are of kinds the rule never reads
  (an empty ``consumes`` means "fire on any change"), and
* ``produces`` — the fact kinds the rule can emit.  Purely declarative
  metadata (the engine never reads it): ``repro.analysis.rulecheck`` builds
  the producer/consumer matrix from it to flag dead rules and orphan kinds
  statically, and cross-checks the declarations against the family-module
  sources.

Several rules may share an op; they fire in registration order (e.g. the
generic congruence rule runs before the op-specific shard rule on ``pad``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Sequence


@dataclass(frozen=True)
class Rule:
    name: str
    ops: frozenset
    consumes: frozenset
    fn: Callable
    produces: frozenset = frozenset()


class RuleRegistry:
    def __init__(self) -> None:
        self.rules: list[Rule] = []
        self._by_op: dict[str, list[Rule]] = {}
        self._fallback: list[Rule] = []

    # -- registration (decorators) -----------------------------------------
    def rule(self, name: str, ops: Iterable[str], consumes: Iterable[str] = (),
             produces: Iterable[str] = ()):
        """Register ``fn(prop, node)`` for the given dist-graph ops."""

        def deco(fn: Callable) -> Callable:
            r = Rule(name, frozenset(ops), frozenset(consumes), fn,
                     frozenset(produces))
            self.rules.append(r)
            for op in r.ops:
                self._by_op.setdefault(op, []).append(r)
            return fn

        return deco

    def fallback(self, name: str, consumes: Iterable[str] = (),
                 produces: Iterable[str] = ()):
        """Register the rule fired for ops with no explicit registration
        (sound default: opaque ops verify only by congruence)."""

        def deco(fn: Callable) -> Callable:
            r = Rule(name, frozenset(), frozenset(consumes), fn,
                     frozenset(produces))
            self.rules.append(r)
            self._fallback.append(r)
            return fn

        return deco

    def noop(self, *ops: str) -> None:
        """Declare ops that fire no rules (leaves / pure-routing ops)."""
        for op in ops:
            self._by_op.setdefault(op, [])

    # -- dispatch ----------------------------------------------------------
    def rules_for(self, op: str) -> Sequence[Rule]:
        got = self._by_op.get(op)
        return self._fallback if got is None else got

    def ops(self) -> set:
        return set(self._by_op)

    def describe(self) -> str:
        lines = []
        for r in self.rules:
            ops = ",".join(sorted(r.ops)) or "<fallback>"
            kinds = ",".join(sorted(r.consumes)) or "*"
            prod = ",".join(sorted(r.produces)) or "-"
            lines.append(f"{r.name}: ops=[{ops}] consumes=[{kinds}] "
                         f"produces=[{prod}]")
        return "\n".join(lines)


# The default registry, populated by the family modules imported from
# ``repro.core.rules.__init__`` (elementwise, layout, dot, reduce,
# collective, slice/concat, congruence, meta).
DEFAULT_REGISTRY = RuleRegistry()
