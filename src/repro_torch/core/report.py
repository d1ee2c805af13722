"""Structured verification reports (the ``repro.verify`` result surface).

One :class:`Report` class serves both API generations: the legacy entry
points (``verify_graphs``/``verify_sharded``/``verify_model_tp``/...) return
it with the original fields populated, and the :class:`repro.verify.Session`
additionally fills the redesigned surface — severity-ranked
:class:`BugSite`\\ s, per-phase :class:`PhaseTimings`, :class:`CacheStats`
proving template reuse across warm calls, per-scenario sub-results for
multi-axis plans, and a stable ``to_json()``/``from_json()`` round trip
(schema-versioned so CI and downstream tools can consume verdicts
machine-readably).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional

from .partition import MemoStats
from .relations import Diagnostic

JSON_SCHEMA_VERSION = 1

# bug-category severity: how likely the finding is a real silent error
# (paper §7.3 categories).  Unlisted categories default to "medium".
SEVERITY = {
    "missing_all_reduce": "high",
    "redundant_all_reduce": "high",
    "wrong_replica_groups": "high",
    "wrong_axis_split": "high",
    "wrong_mesh_axis": "high",
    "layout_mismatch": "high",
    "precision_mismatch": "medium",
    "redundant_all_gather": "medium",
    "dead_collective": "medium",
    "ir_invalid": "high",
    "unverified_frontier": "low",
}
_SEVERITY_ORDER = {"high": 0, "medium": 1, "low": 2}


def severity_of(category: str) -> str:
    return SEVERITY.get(category, "medium")


@dataclass
class BugSite:
    src: str
    op: str
    node: int
    category: str
    detail: str
    repair: Optional[list] = None
    severity: str = ""  # derived from category when not set

    def __post_init__(self) -> None:
        if not self.severity:
            self.severity = severity_of(self.category)

    @property
    def rank(self) -> int:
        return _SEVERITY_ORDER.get(self.severity, 1)


def rank_bug_sites(sites: list) -> list:
    """Severity-ranked order (stable within a severity class)."""
    return sorted(sites, key=lambda b: b.rank)


@dataclass
class PhaseTimings:
    """Wall-clock breakdown of one verification call (seconds)."""

    trace_s: float = 0.0  # jax tracing -> TensorIR (0 on a graph-cache hit)
    stamp_s: float = 0.0  # periodicity validation + IR cloning
    rules_s: float = 0.0  # partitioning + rule evaluation to fixpoint
    localize_s: float = 0.0  # output checks + bug localization
    # per-rule / per-op-family flame summary (RuleProfiler.summary()); only
    # populated under VerifyOptions(profile=True) — off by default because
    # the per-invocation clock reads cost ~15% on the rules phase
    profile: Optional[dict] = None

    @property
    def total_s(self) -> float:
        return self.trace_s + self.stamp_s + self.rules_s + self.localize_s


def op_family(op: str) -> str:
    """Coarse op family used by the profiler's per-family rollup."""
    from .ir import COLLECTIVES, ELEMENTWISE, LAYOUT_OPS, LEAF_OPS, REDUCES

    if op in ELEMENTWISE:
        return "elementwise"
    if op in LAYOUT_OPS or op in ("broadcast", "convert"):
        return "layout"
    if op in COLLECTIVES:
        return "collective"
    if op in REDUCES or op in ("cumsum", "argmax", "sort", "top_k"):
        return "reduce"
    if op in LEAF_OPS:
        return "leaf"
    if op in ("dot", "conv"):
        return "contraction"
    if op in ("slice", "concat", "pad", "gather", "scatter", "dynamic_slice",
              "dynamic_update_slice", "rev"):
        return "structure"
    return "other"


class RuleProfiler:
    """Cumulative per-rule and per-op-family time/invocation counters.

    Attached to a :class:`~repro.core.rules.propagator.Propagator` under
    ``VerifyOptions(profile=True)``; ``dispatch`` wraps each rule firing in
    a monotonic-clock sample.  Thread-backend shard clones get their own
    profiler, merged after the stage barrier (monotonic deltas are additive
    across threads).  ``summary()`` is the JSON flame summary embedded in
    ``Report.timings.profile``."""

    __slots__ = ("rule_time", "rule_count", "op_time", "op_count")

    def __init__(self) -> None:
        self.rule_time: dict[str, float] = {}
        self.rule_count: dict[str, int] = {}
        self.op_time: dict[str, float] = {}
        self.op_count: dict[str, int] = {}

    def record(self, rule: str, op: str, dt: float) -> None:
        self.rule_time[rule] = self.rule_time.get(rule, 0.0) + dt
        self.rule_count[rule] = self.rule_count.get(rule, 0) + 1
        fam = op_family(op)
        self.op_time[fam] = self.op_time.get(fam, 0.0) + dt
        self.op_count[fam] = self.op_count.get(fam, 0) + 1

    def merge(self, other: "RuleProfiler") -> None:
        for k, v in other.rule_time.items():
            self.rule_time[k] = self.rule_time.get(k, 0.0) + v
        for k, c in other.rule_count.items():
            self.rule_count[k] = self.rule_count.get(k, 0) + c
        for k, v in other.op_time.items():
            self.op_time[k] = self.op_time.get(k, 0.0) + v
        for k, c in other.op_count.items():
            self.op_count[k] = self.op_count.get(k, 0) + c

    def summary(self) -> dict:
        rules = {
            name: {"time_s": round(self.rule_time[name], 6),
                   "count": self.rule_count[name]}
            for name in sorted(self.rule_time,
                               key=lambda n: -self.rule_time[n])
        }
        ops = {
            fam: {"time_s": round(self.op_time[fam], 6),
                  "count": self.op_count[fam]}
            for fam in sorted(self.op_time, key=lambda f: -self.op_time[f])
        }
        return {"rules": rules, "op_families": ops}

    @staticmethod
    def merge_summaries(summaries: list) -> Optional[dict]:
        """Combine per-scenario ``summary()`` dicts (Session multi-scenario
        aggregation)."""
        summaries = [s for s in summaries if s]
        if not summaries:
            return None
        out: dict = {"rules": {}, "op_families": {}}
        for s in summaries:
            for section in ("rules", "op_families"):
                for name, row in s.get(section, {}).items():
                    acc = out[section].setdefault(
                        name, {"time_s": 0.0, "count": 0})
                    acc["time_s"] = round(acc["time_s"] + row["time_s"], 6)
                    acc["count"] += row["count"]
        return out


@dataclass
class CacheStats:
    """Session-level cache effectiveness for one verification call.

    ``trace_cached`` proves the graph pair was served from the session's
    trace cache (no re-tracing); ``base_trace_cached`` that the *base*
    (single-device) trace was shared from another scenario of the plan with
    identical program + avals (the base-trace cache is keyed on
    ``(arch, aval signature)``, not the scenario name); ``fp_cached``
    counts layer fingerprints and boundary-input lists served from a
    template cache (stamped periods within a run, every layer on a warm
    re-verify); the remaining counters mirror
    :class:`~repro.core.partition.MemoStats`."""

    trace_cached: bool = False
    base_trace_cached: bool = False
    fp_cached: int = 0
    memo_hits: int = 0
    facts_replayed: int = 0
    settled_nodes: int = 0
    # persistent-store surface (repro.verify.store): the graph pair and its
    # layer templates were served from the on-disk cache (a fresh process
    # warm start), and — for mutated re-verifies — the number of changed
    # nodes the delta path rewrote instead of re-running the full fixpoint
    disk_warm: bool = False
    delta_nodes: int = 0

    @classmethod
    def from_memo(cls, memo: Optional[MemoStats],
                  trace_cached: bool = False) -> "CacheStats":
        if memo is None:
            return cls(trace_cached=trace_cached)
        return cls(
            trace_cached=trace_cached,
            fp_cached=memo.fp_cached,
            memo_hits=memo.memo_hits,
            facts_replayed=memo.facts_replayed,
            settled_nodes=memo.settled_nodes,
        )


@dataclass
class Report:
    verified: bool
    outputs_ok: list
    bug_sites: list
    diagnostics: list
    num_facts: int
    num_base_nodes: int
    num_dist_nodes: int
    elapsed_s: float
    memo: Optional[MemoStats] = None
    unverified_count: int = 0
    rule_invocations: int = 0
    # ---- redesigned surface (populated by repro.verify.Session) ----
    arch: str = ""
    plan: Optional[dict] = None  # Plan.to_dict() of the requested plan
    timings: PhaseTimings = field(default_factory=PhaseTimings)
    cache: CacheStats = field(default_factory=CacheStats)
    # per-scenario sub-results for multi-axis plans: list of dicts with
    # {"scenario", "axis", "size", "verified", "num_facts", ...}
    scenarios: list = field(default_factory=list)
    # lint-preflight result (LintReport.to_dict() from repro.analysis) when
    # Session.verify(..., lint=True) ran the static tier first; kept as a
    # plain dict so core stays import-independent of the analysis package
    lint: Optional[dict] = None
    # equality-saturation tier stats (FusionTier.stats(): classes / merges /
    # seeded / discharged); None when the tier is off.  A derivation-effort
    # counter like num_facts: stripped from canonical()
    egraph: Optional[dict] = None

    def summary(self) -> str:
        head = f"{'VERIFIED' if self.verified else 'UNVERIFIED'}"
        if self.arch:
            head += f" {self.arch}"
            if self.plan:
                head += f" [{_plan_label(self.plan)}]"
        lines = [
            f"{head}: "
            f"{self.num_base_nodes}/{self.num_dist_nodes} nodes (base/dist), "
            f"{self.num_facts} facts, {self.elapsed_s*1e3:.1f} ms"
        ]
        if self.memo:
            lines.append(
                f"  layers={self.memo.layers} memo_hits={self.memo.memo_hits} "
                f"replayed={self.memo.facts_replayed}"
            )
        if self.egraph:
            lines.append(
                f"  egraph: classes={self.egraph.get('classes')} "
                f"merges={self.egraph.get('merges')} "
                f"seeded={self.egraph.get('seeded')} "
                f"discharged={self.egraph.get('discharged')}"
            )
        if self.cache.trace_cached or self.cache.fp_cached:
            lines.append(
                f"  cache: trace={'warm' if self.cache.trace_cached else 'cold'} "
                f"fp_cached={self.cache.fp_cached}"
            )
        if self.lint is not None:
            lines.append(
                f"  lint: {'ok' if self.lint.get('ok') else 'FAILED'} "
                f"({self.lint.get('errors', 0)} errors, "
                f"{self.lint.get('warnings', 0)} warnings)"
            )
        for s in self.scenarios:
            lines.append(
                f"  [{s['scenario']}] {'ok' if s['verified'] else 'FAILED'} "
                f"axis={s['axis']} size={s['size']} facts={s['num_facts']}"
            )
        for b in self.bug_sites[:10]:
            lines.append(
                f"  BUG? [{b.severity}/{b.category}] {b.op} at "
                f"{b.src or '<unknown>'}: {b.detail}"
            )
            if b.repair:
                lines.append(f"        suggested repair bijection: {b.repair}")
        return "\n".join(lines)

    def canonical(self) -> dict:
        """The verdict surface: :meth:`to_json` minus wall-clock, cache
        provenance and derivation-effort counters.  Cold, warm, disk-warm
        and delta runs of the same pair all compare equal here byte-for-byte
        (the CI warm-start smoke and the store tests assert exactly that) —
        fields that depend on HOW the fixpoint was reached are stripped:
        ``num_facts``/``rule_invocations``/``memo`` (memo replay skips the
        failed rule attempts a cold run counts), and ``diagnostics``
        (failed-attempt evidence collected only while rules fire; the bug
        sites distilled from them are kept)."""
        d = json.loads(self.to_json())
        for k in ("elapsed_s", "timings", "cache", "num_facts",
                  "rule_invocations", "memo", "diagnostics", "egraph"):
            d.pop(k, None)
        d["scenarios"] = [
            {k: v for k, v in row.items()
             if k not in ("elapsed_s", "trace_cached", "base_trace_cached",
                          "fp_cached", "disk_warm", "num_facts")}
            for row in d.get("scenarios", [])
        ]
        return d

    # ------------------------------------------------------------- JSON
    def to_json(self, indent: Optional[int] = None) -> str:
        d = {
            "schema": JSON_SCHEMA_VERSION,
            "verified": self.verified,
            "arch": self.arch,
            "plan": self.plan,
            "outputs_ok": [bool(x) for x in self.outputs_ok],
            "num_facts": self.num_facts,
            "num_base_nodes": self.num_base_nodes,
            "num_dist_nodes": self.num_dist_nodes,
            "elapsed_s": self.elapsed_s,
            "unverified_count": self.unverified_count,
            "rule_invocations": self.rule_invocations,
            "memo": asdict(self.memo) if self.memo else None,
            "timings": asdict(self.timings),
            "cache": asdict(self.cache),
            "scenarios": list(self.scenarios),
            "lint": self.lint,
            "egraph": self.egraph,
            "bug_sites": [asdict(b) for b in self.bug_sites],
            "diagnostics": [
                {"dist": g.dist, "category": g.category, "detail": g.detail,
                 "repair": g.repair}
                for g in self.diagnostics
            ],
        }
        return json.dumps(d, indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Report":
        d = json.loads(s)
        if d.get("schema") != JSON_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported report schema {d.get('schema')!r} "
                f"(expected {JSON_SCHEMA_VERSION})"
            )
        return cls(
            verified=d["verified"],
            outputs_ok=list(d["outputs_ok"]),
            bug_sites=[BugSite(**b) for b in d["bug_sites"]],
            diagnostics=[Diagnostic(**g) for g in d["diagnostics"]],
            num_facts=d["num_facts"],
            num_base_nodes=d["num_base_nodes"],
            num_dist_nodes=d["num_dist_nodes"],
            elapsed_s=d["elapsed_s"],
            memo=MemoStats(**d["memo"]) if d.get("memo") else None,
            unverified_count=d["unverified_count"],
            rule_invocations=d["rule_invocations"],
            arch=d.get("arch", ""),
            plan=d.get("plan"),
            timings=PhaseTimings(**d.get("timings", {})),
            cache=CacheStats(**d.get("cache", {})),
            scenarios=list(d.get("scenarios", [])),
            lint=d.get("lint"),
            egraph=d.get("egraph"),
        )


def _plan_label(plan: dict) -> str:
    parts = []
    if plan.get("tp", 1) > 1:
        parts.append(f"tp{plan['tp']}")
    if plan.get("sp"):
        parts.append("sp")
    if plan.get("ep", 1) > 1:
        parts.append(f"ep{plan['ep']}")
    if plan.get("dp", 1) > 1:
        parts.append(f"dp{plan['dp']}x" if plan.get("composite")
                     else f"dp{plan['dp']}")
    mode = plan.get("mode", "forward")
    if plan.get("stages", 1) > 1:
        parts.append(f"pp{plan['stages']}")
    label = "+".join(parts) or "single"
    return f"{label}-{mode}"
