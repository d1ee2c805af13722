"""Detection-benchmark campaign: injector registry x scenario matrix x
property-based graph fuzzing (the paper's Tables 4/5 as a standing gate).

The paper's headline evidence is detection power, not just speed: Scalify
catches every injected silent error with zero false alarms (§7.3).  This
module makes that claim a regression gate.  :func:`run_campaign` expands a
matrix of ``{injector x scenario x arch}``:

* every **clean** cell (one per arch/scenario) must verify — an unverified
  clean cell is a **false positive**;
* every **injected** cell — a registered injector applied to the scenario's
  distributed graph — must NOT verify (**detected** vs **missed**), and the
  injected source site should appear among the top-ranked
  :class:`~repro_torch.core.report.BugSite`\\ s (**localized**);
* injectors whose site predicate rejects every candidate node in a
  scenario's graph are **skipped** (not counted against detection).

All cells of one arch run through a shared warm :class:`Session`
(``mutate_pure=True``: injectors are pure graph surgery, so every injected
cell reuses the clean cell's traced pair — the campaign pays one trace per
scenario, not per cell) and per-cell timings/cache stats are folded into the
:class:`CampaignReport`.

A second generator feeds graphs no hand-written scenario anticipated: the
seeded metamorphic fuzzer (:func:`repro_torch.core.synth.fuzz_tp_mlp`) randomizes
deep-MLP graph pairs and applies seeded registry injections
(:func:`repro_torch.core.synth.fuzz_inject`); each seed contributes a clean cell
and an injected cell with the same accounting.  The report is
schema-versioned JSON; :meth:`CampaignReport.canonical` strips timings and
cache counters so the same seeds produce byte-identical reports (the CI
determinism check).

CLI verb: ``python -m repro_torch.verify campaign --arch llama3_8b --tp 4``.
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional

from repro_torch.core.inject import DEFAULT_INJECTORS, Injection, InjectorError
from repro_torch.core.report import Report
from repro_torch.core.synth import fuzz_inject, fuzz_tp_mlp, input_facts_of
from repro_torch.core.verifier import VerifyOptions, verify_graphs

from .plan import Plan, PlanError
from .scenarios import get_arch_config
from .session import Session

CAMPAIGN_SCHEMA_VERSION = 1

# how many top-ranked bug sites may "contain" the injected site before a
# detection counts as mislocalized (the paper reports exact-line vs
# function-level localization; severity ranking keeps real sites on top)
LOCALIZE_TOP_K = 3

# cell outcomes
DETECTED = "detected"
MISSED = "missed"
MISLOCALIZED = "mislocalized"  # detected, but not in the top-K sites
CLEAN_PASS = "clean_pass"
FALSE_POSITIVE = "false_positive"
SKIPPED = "skipped"


# --------------------------------------------------------------------------
# campaign scenario table: which single-scenario Plans the matrix sweeps.
# Mirrors the scenario registry but binds each kind to a Plan factory and an
# applicability predicate over the arch config (a new axis is one row).

@dataclass(frozen=True)
class CampaignScenario:
    kind: str  # scenario kind (repro_torch.verify.scenarios registry)
    plan_of: Callable  # fn(tp, dp, layers, seq) -> Plan
    applies: Callable = lambda cfg: True  # fn(cfg) -> bool
    note: str = ""


CAMPAIGN_SCENARIOS: tuple[CampaignScenario, ...] = (
    CampaignScenario(
        "tp-forward",
        lambda tp, dp, layers, seq: Plan(tp=tp, layers=layers, seq=seq,
                                         batch=2)),
    CampaignScenario(
        "tp-decode",
        lambda tp, dp, layers, seq: Plan.decode(tp=tp, layers=layers),
        applies=lambda cfg: not cfg.encoder_only,
        note="decoder archs only"),
    CampaignScenario(
        "sp-forward",
        lambda tp, dp, layers, seq: Plan(tp=tp, sp=True, layers=layers,
                                         seq=seq, batch=2),
        applies=lambda cfg: True,
        note="needs seq % tp == 0"),
    CampaignScenario(
        "dp-forward",
        lambda tp, dp, layers, seq: Plan(dp=dp, layers=layers, seq=seq),
        applies=lambda cfg: not cfg.n_experts,
        note="dense archs (MoE gating is data-dependent)"),
    CampaignScenario(
        "dp-grad",
        lambda tp, dp, layers, seq: Plan.grad(dp=dp, layers=layers, seq=8),
        applies=lambda cfg: not cfg.n_experts,
        note="dense archs; short seq (grad traces are wide)"),
    CampaignScenario(
        "ep-moe-forward",
        lambda tp, dp, layers, seq: Plan(ep=tp, layers=layers, seq=seq),
        applies=lambda cfg: bool(cfg.n_experts),
        note="MoE archs only"),
)

SCENARIO_KINDS = tuple(s.kind for s in CAMPAIGN_SCENARIOS)


def campaign_scenarios(kinds: Optional[list] = None
                       ) -> list[CampaignScenario]:
    """Resolve (and validate) the requested scenario subset."""
    if kinds is None:
        return list(CAMPAIGN_SCENARIOS)
    by_kind = {s.kind: s for s in CAMPAIGN_SCENARIOS}
    out = []
    for k in kinds:
        if k not in by_kind:
            raise PlanError(
                f"unknown campaign scenario {k!r} "
                f"(available: {', '.join(SCENARIO_KINDS)})")
        out.append(by_kind[k])
    return out


# --------------------------------------------------------------------------
# result rows


@dataclass
class CampaignCell:
    """One matrix cell: (arch, scenario) x (injector | clean)."""

    arch: str
    scenario: str
    injector: str  # "" for the clean cell
    outcome: str  # detected | missed | clean_pass | false_positive | skipped
    category: str = ""  # expected diagnostic category (injected cells)
    site: str = ""  # injected source site
    localized: bool = False  # site among the top-K ranked BugSites
    category_match: bool = False  # a top site carries the expected category
    # the baseline-free static tier (repro_torch.analysis) also flagged this
    # cell — for injected cells: the bug is catchable without any golden
    # pair; for clean cells: a lint false positive (gated by tests, not here)
    lint_detected: bool = False
    top_sites: list = field(default_factory=list)  # [{src, category, severity}]
    detail: str = ""
    # folded Report stats (excluded from canonical JSON)
    elapsed_s: float = 0.0
    num_facts: int = 0
    trace_cached: bool = False
    fp_cached: int = 0

    def canonical(self) -> dict:
        return {
            "arch": self.arch, "scenario": self.scenario,
            "injector": self.injector, "outcome": self.outcome,
            "category": self.category, "site": self.site,
            "localized": self.localized,
            "category_match": self.category_match,
            "lint_detected": self.lint_detected,
        }


@dataclass
class FuzzCell:
    """One fuzzer seed: a clean verdict plus one injected verdict."""

    seed: int
    spec: dict  # FuzzSpec.to_dict()
    clean_outcome: str  # clean_pass | false_positive
    injector: str  # "" when no registered injector applied
    injected_outcome: str  # detected | missed | skipped
    site: str = ""
    localized: bool = False
    elapsed_s: float = 0.0

    def canonical(self) -> dict:
        d = asdict(self)
        d.pop("elapsed_s")
        return d


@dataclass
class CampaignReport:
    """Schema-versioned detection matrix over scenarios, archs and seeds."""

    archs: list = field(default_factory=list)
    scenarios: list = field(default_factory=list)
    injectors: list = field(default_factory=list)
    cells: list = field(default_factory=list)  # CampaignCell
    fuzz: list = field(default_factory=list)  # FuzzCell
    elapsed_s: float = 0.0

    # -- aggregates --------------------------------------------------------
    def _outcomes(self) -> list[str]:
        return ([c.outcome for c in self.cells]
                + [f.clean_outcome for f in self.fuzz]
                + [f.injected_outcome for f in self.fuzz])

    @property
    def detected(self) -> int:
        return sum(1 for o in self._outcomes() if o in (DETECTED, MISLOCALIZED))

    @property
    def missed(self) -> int:
        return sum(1 for o in self._outcomes() if o == MISSED)

    @property
    def false_positives(self) -> int:
        return sum(1 for o in self._outcomes() if o == FALSE_POSITIVE)

    @property
    def detection_rate(self) -> float:
        total = self.detected + self.missed
        return self.detected / total if total else 1.0

    @property
    def localization_rate(self) -> float:
        """Share of detections whose injected site sits in the top-K
        ranked bug sites (campaign cells; fuzz cells count too)."""
        hits = ([c for c in self.cells
                 if c.outcome in (DETECTED, MISLOCALIZED)]
                + [f for f in self.fuzz if f.injected_outcome == DETECTED])
        if not hits:
            return 1.0
        return sum(1 for c in hits if c.localized) / len(hits)

    @property
    def ok(self) -> bool:
        """The campaign gate: every injected bug caught, no clean cell
        flagged (localization is reported, not gated)."""
        return self.missed == 0 and self.false_positives == 0

    # -- serialization -----------------------------------------------------
    def aggregates(self) -> dict:
        return {
            "detected": self.detected,
            "missed": self.missed,
            "false_positives": self.false_positives,
            "detection_rate": round(self.detection_rate, 4),
            "localization_rate": round(self.localization_rate, 4),
            "ok": self.ok,
        }

    def canonical(self) -> dict:
        """Deterministic subset: same seeds + matrix -> identical JSON
        (timings and cache counters stripped)."""
        return {
            "schema": CAMPAIGN_SCHEMA_VERSION,
            "archs": list(self.archs),
            "scenarios": list(self.scenarios),
            "injectors": list(self.injectors),
            "cells": [c.canonical() for c in self.cells],
            "fuzz": [f.canonical() for f in self.fuzz],
            "aggregates": self.aggregates(),
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        d = self.canonical()
        d["elapsed_s"] = self.elapsed_s
        d["cell_stats"] = [
            {"arch": c.arch, "scenario": c.scenario, "injector": c.injector,
             "elapsed_s": c.elapsed_s, "num_facts": c.num_facts,
             "trace_cached": c.trace_cached, "fp_cached": c.fp_cached,
             "top_sites": c.top_sites, "detail": c.detail}
            for c in self.cells
        ]
        return json.dumps(d, indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "CampaignReport":
        d = json.loads(s)
        if d.get("schema") != CAMPAIGN_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported campaign schema {d.get('schema')!r} "
                f"(expected {CAMPAIGN_SCHEMA_VERSION})")
        stats = {(c["arch"], c["scenario"], c["injector"]): c
                 for c in d.get("cell_stats", [])}
        rep = cls(archs=list(d["archs"]), scenarios=list(d["scenarios"]),
                  injectors=list(d["injectors"]),
                  elapsed_s=d.get("elapsed_s", 0.0))
        for c in d["cells"]:
            st = stats.get((c["arch"], c["scenario"], c["injector"]), {})
            rep.cells.append(CampaignCell(
                **c, top_sites=st.get("top_sites", []),
                detail=st.get("detail", ""),
                elapsed_s=st.get("elapsed_s", 0.0),
                num_facts=st.get("num_facts", 0),
                trace_cached=st.get("trace_cached", False),
                fp_cached=st.get("fp_cached", 0)))
        rep.fuzz = [FuzzCell(**f) for f in d["fuzz"]]
        return rep

    # -- human matrix ------------------------------------------------------
    def summary(self) -> str:
        lines = [f"CAMPAIGN {'OK' if self.ok else 'FAILED'}: "
                 f"{self.detected} detected, {self.missed} missed, "
                 f"{self.false_positives} false positives "
                 f"({self.detection_rate:.0%} detection, "
                 f"{self.localization_rate:.0%} localized, "
                 f"{self.elapsed_s:.1f}s)"]
        mark = {DETECTED: "D", MISLOCALIZED: "d", MISSED: "MISS!",
                CLEAN_PASS: "ok", FALSE_POSITIVE: "FP!", SKIPPED: "-"}
        for arch in self.archs:
            cells = [c for c in self.cells if c.arch == arch]
            if not cells:
                continue
            scens = [s for s in self.scenarios
                     if any(c.scenario == s for c in cells)]
            by = {(c.injector, c.scenario): c for c in cells}
            w = max((len(i) for i in self.injectors), default=7) + 2
            lines.append(f"  {arch}:")
            lines.append("  " + " " * w
                         + " ".join(f"{s:>14s}" for s in scens))
            for inj in [""] + list(self.injectors):
                row = []
                for s in scens:
                    c = by.get((inj, s))
                    row.append(f"{mark.get(c.outcome, '?') if c else '':>14s}")
                label = inj or "(clean)"
                lines.append(f"  {label:<{w}s}" + " ".join(row))
        inj_cells = [c for c in self.cells
                     if c.injector and c.outcome != SKIPPED]
        if inj_cells:
            hits = sum(1 for c in inj_cells if c.lint_detected)
            lines.append(f"  lint tier: {hits}/{len(inj_cells)} injected "
                         f"cells flagged baseline-free")
        if self.fuzz:
            det = sum(1 for f in self.fuzz if f.injected_outcome == DETECTED)
            n_inj = sum(1 for f in self.fuzz if f.injected_outcome != SKIPPED)
            clean = sum(1 for f in self.fuzz if f.clean_outcome == CLEAN_PASS)
            lines.append(
                f"  fuzz: {len(self.fuzz)} seeds, {clean} clean-verified, "
                f"{det}/{n_inj} injections detected")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# runner


def _top_sites(rep: Report, k: int = LOCALIZE_TOP_K) -> list[dict]:
    return [{"src": b.src, "category": b.category, "severity": b.severity}
            for b in rep.bug_sites[:k]]


def _localized(rep: Report, inj: Injection, k: int = LOCALIZE_TOP_K
               ) -> tuple[bool, bool]:
    """(site among top-k ranked sites, expected category among top-k).

    Removed-node injections (e.g. a dropped all_reduce) have no node left to
    blame — the verifier flags the consumer with the expected *category*, so
    category match is the localization signal there (same convention as the
    Tables 4/5 benchmark)."""
    top = rep.bug_sites[:k]
    site_hit = any(b.src == inj.site for b in top)
    cat_hit = any(b.category == inj.category for b in top)
    return site_hit or cat_hit, cat_hit


def _injected_cell(session: Session, arch: str, plan: Plan, scen_kind: str,
                   spec, options: Optional[VerifyOptions]) -> CampaignCell:
    holder: dict = {}

    def mutate(gd):
        # index=1 targets layer code (exact-line localization); index=0
        # falls back to the embedding/postamble region — the convention the
        # Tables 4/5 benchmark uses
        inj = spec(gd, index=1) or spec(gd)
        holder["inj"] = inj
        return inj.graph if inj is not None else gd

    t0 = time.perf_counter()
    rep = session.verify(arch, plan, options=options, mutate_dist=mutate,
                         mutate_pure=True, lint=True)
    dt = time.perf_counter() - t0
    lint_hit = bool(rep.lint) and not rep.lint.get("ok", True)
    inj = holder.get("inj")
    if inj is None:
        return CampaignCell(arch, scen_kind, spec.name, SKIPPED,
                            category=spec.category,
                            detail="no applicable site in this graph",
                            elapsed_s=dt)
    if rep.verified:
        return CampaignCell(arch, scen_kind, spec.name, MISSED,
                            category=inj.category, site=inj.site,
                            lint_detected=lint_hit,
                            detail=inj.description, elapsed_s=dt,
                            num_facts=rep.num_facts,
                            trace_cached=rep.cache.trace_cached,
                            fp_cached=rep.cache.fp_cached)
    localized, cat = _localized(rep, inj)
    return CampaignCell(
        arch, scen_kind, spec.name,
        DETECTED if localized else MISLOCALIZED,
        category=inj.category, site=inj.site, localized=localized,
        category_match=cat, lint_detected=lint_hit,
        top_sites=_top_sites(rep),
        detail=inj.description, elapsed_s=dt, num_facts=rep.num_facts,
        trace_cached=rep.cache.trace_cached, fp_cached=rep.cache.fp_cached)


def _fuzz_cell(seed: int, options: Optional[VerifyOptions],
               injector_names=None) -> FuzzCell:
    t0 = time.perf_counter()
    pair, spec = fuzz_tp_mlp(seed)
    opts = options or VerifyOptions()
    kw = dict(size=spec.size, input_facts=input_facts_of(pair),
              base_inputs=pair.base_inputs, dist_inputs=pair.dist_inputs,
              options=opts)
    clean = verify_graphs(pair.base, pair.dist, **kw)
    clean_outcome = CLEAN_PASS if clean.verified else FALSE_POSITIVE
    inj = fuzz_inject(pair, seed, names=injector_names)
    if inj is None:
        return FuzzCell(seed, spec.to_dict(), clean_outcome, "", SKIPPED,
                        elapsed_s=time.perf_counter() - t0)
    bad = verify_graphs(pair.base, inj.graph, **kw)
    name = inj.name.split("@")[0]
    if bad.verified:
        return FuzzCell(seed, spec.to_dict(), clean_outcome, name, MISSED,
                        site=inj.site, elapsed_s=time.perf_counter() - t0)
    localized, _ = _localized(bad, inj)
    return FuzzCell(seed, spec.to_dict(), clean_outcome, name, DETECTED,
                    site=inj.site, localized=localized,
                    elapsed_s=time.perf_counter() - t0)


def run_campaign(
    archs: list,
    *,
    tp: int = 4,
    dp: int = 2,
    layers: int = 2,
    seq: int = 32,
    scenarios: Optional[list] = None,
    injectors: Optional[list] = None,
    fuzz_seeds: tuple = (),
    options: Optional[VerifyOptions] = None,
    session: Optional[Session] = None,
    cache_dir: Optional[str] = None,
) -> CampaignReport:
    """Sweep the detection matrix and return the :class:`CampaignReport`.

    ``scenarios``/``injectors`` select subsets by name (unknown names raise
    :class:`PlanError` / :class:`InjectorError` — the CLI maps both to exit
    code 2); ``fuzz_seeds`` adds one clean + one injected fuzz cell per
    seed.  ``session`` lets callers reuse an existing warm Session;
    ``cache_dir`` gives the campaign's own Session a persistent warm-start
    store (clean pairs survive across campaign runs — ignored when an
    external ``session`` is passed)."""
    scens = campaign_scenarios(scenarios)
    inj_specs = (DEFAULT_INJECTORS.specs() if injectors is None
                 else [DEFAULT_INJECTORS.get(n) for n in injectors])
    # an explicit --injectors subset bounds the fuzz draw too, so the
    # report's injectors field covers every cell (None = full registry)
    fuzz_names = None if injectors is None else {s.name for s in inj_specs}
    report = CampaignReport(
        archs=list(archs),
        scenarios=[s.kind for s in scens],
        injectors=[s.name for s in inj_specs])
    t0 = time.perf_counter()
    own = session is None
    session = session or Session(options=options, cache_dir=cache_dir)
    try:
        for arch in archs:
            cfg = get_arch_config(arch)
            for cs in scens:
                if not cs.applies(cfg):
                    continue
                plan = cs.plan_of(tp, dp, layers, seq)
                # clean cell: the scenario itself must verify (and its pair
                # lands in the session cache every injected cell reuses)
                t1 = time.perf_counter()
                rep = session.verify(arch, plan, options=options, lint=True)
                clean = CampaignCell(
                    arch, cs.kind, "",
                    CLEAN_PASS if rep.verified else FALSE_POSITIVE,
                    lint_detected=(bool(rep.lint)
                                   and not rep.lint.get("ok", True)),
                    top_sites=_top_sites(rep),
                    elapsed_s=time.perf_counter() - t1,
                    num_facts=rep.num_facts,
                    trace_cached=rep.cache.trace_cached,
                    fp_cached=rep.cache.fp_cached)
                report.cells.append(clean)
                for spec in inj_specs:
                    report.cells.append(_injected_cell(
                        session, arch, plan, cs.kind, spec, options))
    finally:
        if own:
            session.close()
    for seed in fuzz_seeds:
        report.fuzz.append(_fuzz_cell(int(seed), options, fuzz_names))
    report.elapsed_s = time.perf_counter() - t0
    return report


__all__ = [
    "CAMPAIGN_SCHEMA_VERSION", "CAMPAIGN_SCENARIOS", "SCENARIO_KINDS",
    "CampaignCell", "CampaignReport", "CampaignScenario", "FuzzCell",
    "run_campaign", "InjectorError",
]
