"""Static checker for the rule registry itself.

Builds the fact-kind producer/consumer matrix across
``src/repro/core/rules/*`` from the declarative ``consumes``/``produces``
annotations and flags:

* **dead rules** — a rule whose ``consumes`` kinds are produced by no rule
  and never seeded (input registration seeds ``dup``/``shard``; the scoped
  meta rules seed ``partial``): the rule can never fire;
* **orphan kinds** — a kind in :data:`repro.core.relations.KINDS` that is
  produced (or seeded) but consumed by no rule and checked by no output
  check: deriving it is wasted work;
* **declaration drift** — a family module whose source constructs
  ``Fact(<kind>, ...)`` not covered by its rules' declared ``produces``,
  or reads a kind (``facts_kind``/``f.kind ==``) not covered by declared
  ``consumes`` (the semi-naive engine skips re-firing on undeclared
  kinds, so drift here is a real soundness bug, not just stale metadata);
* **op coverage** — ops appearing in zoo traces with no registered rule
  (they fall back to generic congruence: reported, not gated).

``python -m repro.verify rulecheck`` gates CI on the first three.
"""
from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from repro_torch.core.relations import DUP, KIND_CONSTANTS, KINDS, PARTIAL, SHARD
from repro_torch.core.rules.registry import DEFAULT_REGISTRY, RuleRegistry

RULECHECK_SCHEMA_VERSION = 1

# kinds seeded outside any registered rule: input registration
# (repro.verify.specs) seeds dup/shard; the scoped meta rules
# (rules/meta.py, not registry-registered) seed partial + dup
SEEDED_KINDS = frozenset({DUP, SHARD, PARTIAL})

# output checks (core/verifier.py) consume dup/shard facts on graph outputs
OUTPUT_CHECK_KINDS = frozenset({DUP, SHARD, PARTIAL})

# rules allowed to consume kinds nothing produces / kinds allowed to stay
# unconsumed — empty today; add entries here (with a comment why) instead
# of weakening the gate
DEAD_RULE_ALLOWLIST: frozenset = frozenset()
ORPHAN_KIND_ALLOWLIST: frozenset = frozenset()

# modules scanned for declaration drift (meta.py is excluded: its scoped
# templates are not registry rules, so they have no declarations to drift
# from — their emissions are modeled as SEEDED_KINDS instead)
_FAMILY_MODULES = ("collective", "congruence", "dot", "elementwise",
                   "layout", "reduce", "sliceops")


@dataclass
class RulecheckReport:
    """Result of one registry static check (``ok`` gates CI)."""

    dead_rules: list = field(default_factory=list)  # [{rule, consumes}]
    orphan_kinds: list = field(default_factory=list)  # [kind]
    unproduced_consumed: list = field(default_factory=list)  # [kind]
    drift: list = field(default_factory=list)  # [{module, kind, direction}]
    uncovered_ops: list = field(default_factory=list)  # ops -> fallback only
    producers: dict = field(default_factory=dict)  # kind -> [rule names]
    consumers: dict = field(default_factory=dict)  # kind -> [rule names]
    num_rules: int = 0
    num_ops: int = 0

    @property
    def ok(self) -> bool:
        """Gate: coverage gaps are informational, the rest are failures."""
        return not (self.dead_rules or self.orphan_kinds
                    or self.unproduced_consumed or self.drift)

    def to_dict(self) -> dict:
        return {
            "schema": RULECHECK_SCHEMA_VERSION,
            "ok": self.ok,
            "dead_rules": self.dead_rules,
            "orphan_kinds": self.orphan_kinds,
            "unproduced_consumed": self.unproduced_consumed,
            "drift": self.drift,
            "uncovered_ops": self.uncovered_ops,
            "producers": self.producers,
            "consumers": self.consumers,
            "num_rules": self.num_rules,
            "num_ops": self.num_ops,
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def summary(self) -> str:
        lines = [f"RULECHECK {'OK' if self.ok else 'FAILED'}: "
                 f"{self.num_rules} rules over {self.num_ops} ops"]
        for kind in KINDS:
            lines.append(
                f"  {kind:10s} produced-by={len(self.producers.get(kind, []))}"
                f" consumed-by={len(self.consumers.get(kind, []))}")
        for r in self.dead_rules:
            lines.append(f"  DEAD RULE {r['rule']}: consumes "
                         f"{','.join(r['consumes'])} which nothing produces")
        for k in self.orphan_kinds:
            lines.append(f"  ORPHAN KIND {k}: produced but never consumed")
        for k in self.unproduced_consumed:
            lines.append(f"  UNPRODUCED KIND {k}: consumed but never "
                         f"produced or seeded")
        for d in self.drift:
            lines.append(f"  DRIFT {d['module']}: {d['direction']} "
                         f"{d['kind']} undeclared")
        if self.uncovered_ops:
            lines.append(f"  fallback-only ops in traces: "
                         f"{', '.join(self.uncovered_ops)}")
        return "\n".join(lines)


def _module_kind_usage(path: Path) -> tuple[set, set]:
    """(kinds constructed into Facts, kinds read from the store) in one
    family module's source — the ground truth the declarations must cover."""
    kind_names = KIND_CONSTANTS  # DUP -> "dup", ...
    produced: set = set()
    consumed: set = set()
    tree = ast.parse(path.read_text())

    def kind_of(node) -> Optional[str]:
        if isinstance(node, ast.Name) and node.id in kind_names:
            return kind_names[node.id]
        return None

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = (fn.id if isinstance(fn, ast.Name)
                    else fn.attr if isinstance(fn, ast.Attribute) else "")
            if name == "Fact" and node.args:
                k = kind_of(node.args[0])
                if k:
                    produced.add(k)
            elif name == "facts_kind" and len(node.args) >= 2:
                k = kind_of(node.args[1])
                if k:
                    consumed.add(k)
        elif isinstance(node, ast.Compare):
            # f.kind == KIND (any comparator side)
            sides = [node.left] + list(node.comparators)
            is_kind_cmp = any(
                isinstance(s, ast.Attribute) and s.attr == "kind"
                for s in sides)
            if is_kind_cmp:
                for s in sides:
                    k = kind_of(s)
                    if k:
                        consumed.add(k)
    return produced, consumed


def _registry_matrix(registry: RuleRegistry):
    producers: dict[str, list] = {k: [] for k in KINDS}
    consumers: dict[str, list] = {k: [] for k in KINDS}
    for r in registry.rules:
        for k in r.produces:
            producers.setdefault(k, []).append(r.name)
        for k in r.consumes:
            consumers.setdefault(k, []).append(r.name)
    return producers, consumers


def check_registry(registry: RuleRegistry = DEFAULT_REGISTRY,
                   traced_ops: Optional[set] = None,
                   rules_dir: Optional[Path] = None) -> RulecheckReport:
    """Run the full registry static check.

    ``traced_ops``: ops observed in real traces (see :func:`trace_ops`) for
    the coverage matrix; None skips that section.  ``rules_dir`` overrides
    where family-module sources are read from (tests)."""
    rep = RulecheckReport(num_rules=len(registry.rules),
                          num_ops=len(registry.ops()))
    producers, consumers = _registry_matrix(registry)
    rep.producers = {k: sorted(set(v)) for k, v in producers.items()}
    rep.consumers = {k: sorted(set(v)) for k, v in consumers.items()}

    produced_kinds = frozenset(
        k for k, v in producers.items() if v) | SEEDED_KINDS

    # dead rules: every consumed kind unproduced -> the rule can never fire
    for r in registry.rules:
        if r.name in DEAD_RULE_ALLOWLIST or not r.consumes:
            continue  # empty consumes = fires on any change: alive
        if not (r.consumes & produced_kinds):
            rep.dead_rules.append(
                {"rule": r.name, "consumes": sorted(r.consumes)})

    # orphan kinds: produced/seeded but consumed by nothing
    for k in KINDS:
        if k in ORPHAN_KIND_ALLOWLIST:
            continue
        if k in produced_kinds and not consumers.get(k) \
                and k not in OUTPUT_CHECK_KINDS:
            rep.orphan_kinds.append(k)
        if consumers.get(k) and k not in produced_kinds:
            rep.unproduced_consumed.append(k)

    # declaration drift vs module sources
    if rules_dir is None:
        import repro_torch.core.rules as _pkg

        rules_dir = Path(_pkg.__file__).parent
    for mod in _FAMILY_MODULES:
        path = rules_dir / f"{mod}.py"
        if not path.exists():
            continue
        src_produced, src_consumed = _module_kind_usage(path)
        mod_rules = [r for r in registry.rules
                     if r.fn.__module__.endswith(f".{mod}")]
        declared_p = frozenset().union(*[r.produces for r in mod_rules]) \
            if mod_rules else frozenset()
        declared_c = frozenset().union(*[r.consumes for r in mod_rules]) \
            if mod_rules else frozenset()
        for k in sorted(src_produced - declared_p):
            rep.drift.append(
                {"module": mod, "kind": k, "direction": "produces"})
        for k in sorted(src_consumed - declared_c):
            rep.drift.append(
                {"module": mod, "kind": k, "direction": "consumes"})

    # op coverage vs real traces (informational)
    if traced_ops is not None:
        registered = registry.ops()
        rep.uncovered_ops = sorted(traced_ops - registered)
    return rep


def trace_ops(archs, tp: int = 4, layers: int = 2) -> set:
    """Ops appearing in zoo traces (the coverage-matrix input)."""
    from .single import trace_lint_unit

    ops: set = set()
    for arch in archs:
        unit = trace_lint_unit(arch, tp, layers=layers)
        ops.update(n.op for n in unit.graph)
    return ops
