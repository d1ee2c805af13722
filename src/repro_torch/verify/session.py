"""The verification session: one object owning all cross-call state.

A :class:`Session` is the warm-start entry point the stateless one-shots
never had: it keeps

  * a **trace cache** — traced (and stamped) graph pairs keyed by
    ``(arch, cfg-hash, scenario)``, so re-verifying the same architecture
    (model-zoo sweeps, re-verify after an edit elsewhere) skips tracing
    entirely (``Report.cache.trace_cached``);
  * **template caches** (:class:`~repro_torch.core.partition.TemplateCache`) keyed
    alongside — per-layer fact templates, stamped-period structures and
    layer fingerprints, so a warm re-verify replays every layer from memo
    without re-fingerprinting (``Report.cache.fp_cached > 0``);
  * a **persistent worker pool** shared by every worklist-engine parallel
    sweep (``VerifyOptions(parallel_workers=N)``) instead of a pool per
    call.

Interning note: ``Fact.key()`` / shard-stack / identity ``Layout`` objects
are interned at module scope (``rules/common.py``, ``bijection.py``), so
they are shared across a session's calls by construction.
"""
from __future__ import annotations

import concurrent.futures as _fut
import dataclasses
import hashlib
import time
from dataclasses import replace
from typing import Optional

from repro_torch.core.ir import diff_graphs
from repro_torch.core.partition import TemplateCache, delta_template_cache
from repro_torch.core.report import (CacheStats, PhaseTimings, Report,
                                     RuleProfiler, rank_bug_sites)
from repro_torch.core.verifier import VerifyOptions, resolve_backend, verify_graphs

from .plan import Plan, Scenario
from .scenarios import GraphPair, build_pair, get_arch_config
from .store import DiskCache

__all__ = ["Session", "verify"]


def _cfg_hash(cfg) -> str:
    payload = repr(sorted(dataclasses.asdict(cfg).items()))
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


class Session:
    """Reusable verification session (the single public entry point).

    >>> with Session() as s:
    ...     cold = s.verify("llama3_8b", Plan(tp=16))
    ...     warm = s.verify("llama3_8b", Plan(tp=16))  # served from caches
    >>> warm.cache.trace_cached, warm.cache.fp_cached > 0
    (True, True)
    """

    def __init__(self, *, options: Optional[VerifyOptions] = None,
                 cache_dir: Optional[str] = None):
        self.options = options
        # persistent warm-start store (repro_torch.verify.store): traced pairs +
        # template caches survive the process; None = in-memory only
        self._store: Optional[DiskCache] = (
            DiskCache(cache_dir) if cache_dir else None)
        self._persisted: set[tuple] = set()  # keys already on disk
        self._graphs: dict[tuple, GraphPair] = {}
        self._templates: dict[tuple, TemplateCache] = {}
        # base (single-device) traces shared ACROSS scenarios: keyed on
        # (arch/cfg, program tag, aval signature) — not the scenario name —
        # so e.g. tp-forward and sp-forward of one plan trace the baseline
        # once (Report.cache.base_trace_cached)
        self._base_traces: dict[tuple, tuple] = {}
        self._pool: Optional[_fut.ThreadPoolExecutor] = None
        self._pool_size = 0
        # persistent process pool for the "process" shard backend: worker
        # processes cache unpickled graph pairs, so reuse across calls
        # amortizes both fork cost and pair shipping
        self._ppool: Optional[_fut.ProcessPoolExecutor] = None
        self._ppool_size = 0

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
            self._pool_size = 0
        if self._ppool is not None:
            self._ppool.shutdown(wait=True, cancel_futures=True)
            self._ppool = None
            self._ppool_size = 0

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def clear(self) -> None:
        """Drop all cached graphs and templates (keep the pool)."""
        self._graphs.clear()
        self._templates.clear()
        self._base_traces.clear()

    def stats(self) -> dict:
        out = {
            "cached_graphs": len(self._graphs),
            "cached_templates": len(self._templates),
            "cached_base_traces": len(self._base_traces),
            "pool_workers": self._pool_size,
        }
        if self._store is not None:
            out["disk"] = {"hits": self._store.hits,
                           "misses": self._store.misses,
                           "saves": self._store.saves}
        return out

    def _get_pool(self, options: VerifyOptions):
        """The session pool matching the options' resolved backend."""
        workers = options.parallel_workers
        if workers <= 1:
            return None
        if resolve_backend(options) == "process":
            if self._ppool is None or self._ppool_size < workers:
                from repro_torch.core.rules.engine import _process_pool

                if self._ppool is not None:
                    self._ppool.shutdown(wait=True)
                self._ppool = _process_pool(workers)
                self._ppool_size = workers
            return self._ppool
        if self._pool is None or self._pool_size < workers:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
            self._pool = _fut.ThreadPoolExecutor(max_workers=workers)
            self._pool_size = workers
        return self._pool

    # ------------------------------------------------------------ verify
    def verify(self, arch: str, plan: Optional[Plan] = None, *,
               options: Optional[VerifyOptions] = None,
               mutate_dist=None, mutate_pure: bool = False,
               lint: bool = False, **plan_kw) -> Report:
        """Verify ``arch`` under ``plan`` (or ``Plan(**plan_kw)``).

        ``mutate_dist`` (testing/bug-injection hook) receives each
        scenario's distributed graph and returns the mutated graph; mutated
        runs bypass the graph-pair and template caches (mutation acts on a
        fresh copy, so the shared *base-trace* cache stays in use — it
        holds only unmutated traces).  ``mutate_pure=True`` declares the
        mutation never modifies its input graph (true of every
        ``repro_torch.core.inject`` injector — surgery builds a fresh Graph):
        the *unmutated* pair is then served from / stored into the
        graph-pair cache, so an injection campaign pays one trace per
        scenario instead of one per cell.  Template caches stay bypassed
        either way (they describe the unmutated pair).

        ``lint=True`` runs the baseline-free static tier
        (:mod:`repro_torch.analysis`) over each scenario's distributed graph —
        after mutation, so injected bugs are linted — and attaches the
        result as ``Report.lint`` (a ``LintReport.to_dict()``); the
        relational verdict is unaffected."""
        if plan is not None and plan_kw:
            raise TypeError(
                f"pass either a Plan or plan keywords, not both "
                f"(got plan and {sorted(plan_kw)})")
        plan = plan if plan is not None else Plan(**plan_kw)
        options = options or self.options or VerifyOptions()
        cfg_h = _cfg_hash(get_arch_config(arch, smoke=plan.smoke))
        t0 = time.perf_counter()
        results: list[tuple[Scenario, Report]] = []
        for scen in plan.scenarios():
            results.append(
                (scen, self._run_scenario(arch, cfg_h, plan, scen, options,
                                          mutate_dist, mutate_pure,
                                          lint=lint)))
        report = _merge(arch, plan, results)
        report.elapsed_s = time.perf_counter() - t0
        return report

    def _run_scenario(self, arch: str, cfg_h: str, plan: Plan, scen: Scenario,
                      options: VerifyOptions, mutate_dist,
                      mutate_pure: bool = False, lint: bool = False) -> Report:
        key = (arch, cfg_h, scen.name, scen.size, plan.layers, plan.batch,
               plan.seq, plan.max_len, plan.stages, plan.tp, options.stamp)
        cacheable = mutate_dist is None or mutate_pure
        disk_warm = False
        pair = self._graphs.get(key) if cacheable else None
        if pair is None and cacheable and self._store is not None:
            hit = self._store.load(key)
            if hit is not None:
                # disk warm start: the traced pair AND its template cache
                # come back from a previous process — no trace, and the
                # verify below memo-replays every layer
                pair, tpls = hit
                self._graphs[key] = pair
                self._templates[key] = tpls
                self._persisted.add(key)
                disk_warm = True
        cached = pair is not None
        if pair is None:
            pair = build_pair(arch, plan, scen, stamp=options.stamp,
                              base_cache=self._base_traces,
                              base_key=(arch, cfg_h))
            if cacheable:
                self._graphs[key] = pair
        dist = pair.dist
        delta_nodes = 0
        if mutate_dist is not None:
            dist = mutate_dist(dist)
            # a pure identity mutation (hook returned the input unchanged)
            # keeps the stamp; anything else — a new graph, or a possibly
            # in-place edit under the default impure contract — invalidates
            # the periodicity metadata
            if not (mutate_pure and dist is pair.dist):
                dist.stamp = None
            cache = None  # templates belong to the unmutated pair
            # delta re-verification: when the mutated graph differs from the
            # cached clean one in a bounded node set, verify with a
            # delta-derived template view — unchanged layers memo-replay,
            # only the edited layers (and fact-changed downstream) rewrite.
            # Verdict/fact-set parity with a from-scratch run holds because
            # memo entries are content-addressed (a changed layer's
            # fingerprint can never hit a clean entry).
            if (dist is not pair.dist and options.delta
                    and options.partition and options.memoize):
                clean = self._templates.get(key)
                if clean is not None and clean.memo:
                    delta = diff_graphs(pair.dist, dist,
                                        max_changed=options.delta_max_nodes)
                    if delta is not None:
                        cache = delta_template_cache(
                            clean, delta, pair.dist, dist)
                        delta_nodes = len(delta.changed)
        else:
            cache = self._templates.setdefault(key, TemplateCache())
        timings = PhaseTimings(
            trace_s=0.0 if cached else pair.trace_s,
            stamp_s=0.0 if cached else pair.stamp_s)
        opts = replace(options, axis=pair.axis)
        rep = verify_graphs(
            pair.base, dist,
            size=pair.size,
            input_facts=pair.input_facts,
            base_inputs=pair.base_inputs,
            dist_inputs=pair.dist_inputs,
            output_specs=pair.output_specs,
            options=opts,
            cache=cache,
            pool=self._get_pool(options),
            timings=timings,
        )
        rep.cache.trace_cached = cached
        rep.cache.base_trace_cached = pair.base_cached
        # traced TRACE_PERIODS block periods and stamped the rest
        rep.stamped = pair.stamped
        rep.cache.disk_warm = disk_warm
        rep.cache.delta_nodes = delta_nodes
        if (self._store is not None and mutate_dist is None
                and key not in self._persisted):
            # persist after a clean verify: the templates were just filled
            # (or refreshed) by the run above
            if self._store.save(key, pair, self._templates[key]):
                self._persisted.add(key)
        if lint:
            rep.lint = _lint_pair(arch, pair, dist).to_dict()
        return rep

    # ------------------------------------------------- function-pair entry
    def verify_sharded(self, base_fn, dist_fn, *avals, **kw) -> Report:
        """Session-flavored :func:`repro_torch.core.verify_sharded` (function
        pairs are not cacheable — this exists so code written against the
        Session API has one entry point for ad-hoc pairs too)."""
        from repro_torch.core.verifier import verify_sharded as _vs

        kw.setdefault("options", self.options)
        return _vs(base_fn, dist_fn, *avals, **kw)


def _lint_pair(arch: str, pair: GraphPair, dist):
    """Lint-preflight one scenario's distributed graph (post-mutation)."""
    from repro_torch.analysis import pair_lint_unit, run_lints, unit_context

    unit = pair_lint_unit(pair, arch=arch)
    if dist is not pair.dist:
        unit = unit.mutate(lambda _g: dist)
    return run_lints(unit_context(unit))


def _merge_lint(dicts: list) -> dict:
    """Fold per-scenario LintReport dicts into one (multi-scenario plans)."""
    import json as _json

    from repro_torch.analysis import LintReport

    merged = LintReport()
    for d in dicts:
        merged = merged.merge(LintReport.from_json(_json.dumps(d)))
    return merged.to_dict()


def _merge(arch: str, plan: Plan, results) -> Report:
    """Aggregate per-scenario reports into the plan-level report.

    Single-scenario plans keep their report verbatim (verdict and fact
    counts identical to the legacy entry points); multi-scenario plans
    combine verdicts conjunctively and sum the counters."""
    scen_rows = [
        {
            "scenario": scen.name,
            "axis": scen.axis,
            "size": scen.size,
            "verified": rep.verified,
            "num_facts": rep.num_facts,
            "num_dist_nodes": rep.num_dist_nodes,
            "unverified_count": rep.unverified_count,
            "elapsed_s": rep.elapsed_s,
            "trace_cached": rep.cache.trace_cached,
            "base_trace_cached": rep.cache.base_trace_cached,
            "fp_cached": rep.cache.fp_cached,
            "disk_warm": rep.cache.disk_warm,
            "lint_ok": rep.lint.get("ok") if rep.lint is not None else None,
            "stamped": rep.stamped,
        }
        for scen, rep in results
    ]
    if len(results) == 1:
        rep = results[0][1]
    else:
        reps = [r for _, r in results]
        rep = Report(
            verified=all(r.verified for r in reps),
            outputs_ok=[ok for r in reps for ok in r.outputs_ok],
            bug_sites=rank_bug_sites([b for r in reps for b in r.bug_sites]),
            diagnostics=[d for r in reps for d in r.diagnostics],
            num_facts=sum(r.num_facts for r in reps),
            num_base_nodes=sum(r.num_base_nodes for r in reps),
            num_dist_nodes=sum(r.num_dist_nodes for r in reps),
            elapsed_s=sum(r.elapsed_s for r in reps),
            # no single memo covers a multi-scenario plan; the per-scenario
            # rows below carry the layer/memo detail
            memo=None,
            unverified_count=sum(r.unverified_count for r in reps),
            rule_invocations=sum(r.rule_invocations for r in reps),
            timings=PhaseTimings(
                trace_s=sum(r.timings.trace_s for r in reps),
                stamp_s=sum(r.timings.stamp_s for r in reps),
                rules_s=sum(r.timings.rules_s for r in reps),
                localize_s=sum(r.timings.localize_s for r in reps),
                profile=RuleProfiler.merge_summaries(
                    [r.timings.profile for r in reps]),
            ),
            cache=CacheStats(
                trace_cached=all(r.cache.trace_cached for r in reps),
                base_trace_cached=any(r.cache.base_trace_cached for r in reps),
                fp_cached=sum(r.cache.fp_cached for r in reps),
                memo_hits=sum(r.cache.memo_hits for r in reps),
                facts_replayed=sum(r.cache.facts_replayed for r in reps),
                settled_nodes=sum(r.cache.settled_nodes for r in reps),
                disk_warm=all(r.cache.disk_warm for r in reps),
                delta_nodes=sum(r.cache.delta_nodes for r in reps),
            ),
        )
        rep.stamped = all(r.stamped for r in reps)
        lints = [r.lint for r in reps if r.lint is not None]
        if lints:
            rep.lint = _merge_lint(lints)
        egraphs = [r.egraph for r in reps if r.egraph is not None]
        if egraphs:
            rep.egraph = {
                k: sum(e.get(k, 0) for e in egraphs)
                for k in ("classes", "merges", "seeded", "discharged")
            }
    rep.arch = arch
    rep.plan = plan.to_dict()
    rep.scenarios = scen_rows
    return rep


def verify(arch: str, plan: Optional[Plan] = None, **kw) -> Report:
    """One-shot convenience: a throwaway :class:`Session`."""
    with Session() as s:
        return s.verify(arch, plan, **kw)
