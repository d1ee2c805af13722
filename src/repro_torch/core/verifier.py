"""Graph-level verification entry points + bug localization (paper §5.3).

``verify_graphs`` is the engine entry point over two TensorIR graphs;
``verify_sharded`` is the convenience wrapper that traces a baseline torch
function and its per-rank tensor-parallel counterpart and verifies them in
one call.

The *model-level* public API lives in :mod:`repro_torch.verify` (``Session`` /
``Plan`` / ``Report``): it owns the cross-call state (persistent worker
pool, trace + template caches) and calls ``verify_graphs`` with the
``cache``/``pool``/``timings`` hooks below.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

from .ir import ELEMENTWISE, Graph, LEAF_OPS
from .partition import PartitionedVerifier, TemplateCache
from .relations import DUP, PARTIAL, SHARD, Diagnostic, RelStore
from .report import BugSite, CacheStats, PhaseTimings, Report, rank_bug_sites
from .rules import Propagator, WorklistEngine
from .trace import trace, trace_sharded


@dataclass
class InputFact:
    """Declared relation between baseline input i and distributed input j."""

    kind: str  # 'dup' | 'shard'
    base_index: int
    dist_index: int
    dim: int = -1  # shard dim


@dataclass
class OutputSpec:
    kind: str = "dup"  # expected placement: 'dup' | 'shard' | 'partial'
    dim: int = -1
    reduce_op: str = "add"


@dataclass
class VerifyOptions:
    partition: bool = True
    memoize: bool = True
    # staged parallel rewriting (paper Fig. 5).  Applies to BOTH engines:
    # the pass engine fans stage subtopologies out on a per-run pool; the
    # worklist engine runs its initial per-layer sweep on shard-local fact
    # overlays merged through RelStore.add_batch.  0/1 = serial.
    parallel_workers: int = 0
    # worker backend for the worklist engine's parallel sweep:
    #   "thread"  — stage-sharded thread pool (GIL-bound; cheap to ship)
    #   "process" — picklable chunk work units on a ProcessPoolExecutor
    #               (repro.core.rules.parshard): actually parallel
    #   "auto"    — process when workers > 1, fork is available, and the
    #               machine has cores to fan out onto; thread otherwise
    parallel_backend: str = "auto"
    max_passes: int = 30  # pass engine only
    axis: str = "model"
    # "worklist": semi-naive incremental evaluation (default);
    # "passes": the pass-based rescan loop (parity reference)
    engine: str = "worklist"
    # layer stamping (repro.core.stamp): trace O(block_period) layers and
    # clone the rest in the IR.  Only consulted by the model-level entry
    # points (repro.verify / verify_model_tp / verify_decode_tp);
    # verify_graphs receives already-built graphs.
    stamp: bool = True
    # per-rule / per-op-family profiling into Report.timings.profile
    # (RuleProfiler); off by default — it wraps every rule firing in
    # monotonic clock reads
    profile: bool = False
    # process-backend chunk planning (repro.core.rules.parshard): max nodes
    # absorbed into one chunk's input cone, minimum offloadable region size,
    # and the chunks-per-worker target the planner sizes chunks against
    chunk_cone_cap: int = 64
    chunk_min_offload: int = 64
    chunks_per_worker: int = 3
    # delta re-verification (repro.verify.Session): when a mutated graph
    # differs from the cached clean pair in at most ``delta_max_nodes``
    # nodes, re-verify with a delta-derived template cache (changed layers
    # invalidated, the rest replayed) instead of from scratch
    delta: bool = True
    delta_max_nodes: int = 96
    # equality-saturation fusion tier (repro.core.rules.fusion): one shared
    # e-graph over both graphs; relational facts seed e-class merges and
    # congruent base/dist classes discharge DUP facts without rule firing.
    # On by default (the trimmed default rule registry relies on it); off
    # falls back to the legacy registry with the retired congruence rules,
    # preserving pre-fusion behavior exactly (rules/legacy.py)
    fusion: bool = True


def resolve_backend(options: "VerifyOptions") -> str:
    """The concrete worker backend for these options ("thread"|"process").

    Shared by ``verify_graphs`` and ``Session._get_pool`` so both pick the
    same pool flavor for a given options object.  "auto" falls back to
    "thread" on single-core machines: worker processes there only add
    fork + pickling overhead with no CPU to overlap onto.  An explicit
    "process" is always honored (parity tests and benchmarks pin it)."""
    backend = options.parallel_backend
    if backend == "auto":
        import os

        from .rules.engine import fork_available

        return ("process" if options.parallel_workers > 1 and fork_available()
                and (os.cpu_count() or 1) > 1 else "thread")
    if backend not in ("thread", "process"):
        raise ValueError(
            f"unknown parallel_backend {backend!r}: thread|process|auto")
    return backend


def _output_ok(store: RelStore, b_out: int, d_out: int, spec: OutputSpec, size: int) -> bool:
    for f in store.facts(d_out):
        if f.base != b_out:
            continue
        if spec.kind == DUP and f.kind == DUP and f.clean:
            return True
        if spec.kind == SHARD and f.kind == SHARD and f.clean:
            # check device atom lands on the expected dim
            lay = f.layout
            dev_atom = lay.perm[0]
            acc = 0
            for dim, g in enumerate(lay.src_groups):
                if acc <= dev_atom < acc + g:
                    if dim == spec.dim:
                        return True
                    break
                acc += g
        if spec.kind == "partial" and f.kind == "partial" and f.reduce_op == spec.reduce_op:
            return True
    return False


# leaf ops whose *unverified* status does not disqualify a node from the
# frontier: they carry no relational facts of their own (pure functions of
# attributes), so a consumer with otherwise-verified inputs is still the
# first explainable failure point
_FRONTIER_LEAF_OPS = ("const", "iota", "axis_index")


def _frontier_ready(store: RelStore, dist: Graph, n) -> bool:
    """True when ``n`` sits on the unverified frontier: it has inputs, and
    every input is either verified or an attribute-only leaf."""
    return bool(n.inputs) and all(
        store.verified(i) or dist[i].op in _FRONTIER_LEAF_OPS
        for i in n.inputs
    )


# unary fact-carrying ops a twisted layout flows through unchanged: walking
# this chain upstream from a frontier finds the op that introduced the twist
_LAYOUT_CHAIN_OPS = frozenset(
    {"reshape", "transpose", "convert", "broadcast",
     "all_gather", "reduce_scatter", "all_to_all"}
)


def _blame_twisted_layout(store: RelStore, dist: Graph, n):
    """The producer op that twisted the layout reaching frontier node ``n``.

    A layout bug (wrong transpose permutation, wrong all_gather dim) does
    not fail *at* the mutated op — layout composition soundly carries a
    permuted fact through it — it fails at the first consumer that needs
    the aligned form.  When a frontier input holds facts but none of them
    clean, walk its producer chain upstream through layout-carrying ops:
    the op whose own input still has a clean fact is where the twist was
    introduced (paper §5.3's exact-line localization for category-4/5
    bugs)."""
    def clean(nid: int) -> bool:
        return any(f.clean for f in store.facts(nid))

    # DFS upstream through twisted fact-carrying nodes; elementwise ops are
    # layout-transparent (they propagate the twist), so the walk crosses
    # them but only a layout-moving op can be the culprit
    stack, seen, budget = list(n.inputs), set(), 256
    while stack and budget > 0:
        budget -= 1
        i = stack.pop()
        if i in seen:
            continue
        seen.add(i)
        facts = store.facts(i)
        if not facts or clean(i):
            continue
        cur = dist[i]
        if cur.op in _LAYOUT_CHAIN_OPS and cur.inputs and clean(cur.inputs[0]):
            return cur
        if cur.op in _LAYOUT_CHAIN_OPS or cur.op in ELEMENTWISE:
            stack.extend(cur.inputs)
    return None


def localize(base: Graph, dist: Graph, store: RelStore) -> list[BugSite]:
    """Paper §5.3: report unverified nodes whose inputs are all verified,
    joined with the diagnostics collected during rule matching; frontier
    nodes fed by a twisted-layout chain additionally blame the op that
    introduced the twist."""
    diag_by_node: dict[int, list[Diagnostic]] = {}
    for d in store.diagnostics:
        diag_by_node.setdefault(d.dist, []).append(d)
    sites: list[BugSite] = []
    seen_src: set[tuple] = set()
    for n in dist:
        if n.op in LEAF_OPS or store.verified(n.id):
            continue
        if n.id in store.covered_nodes or (n.scope and n.scope in store.covered_scopes):
            continue  # inside a region verified wholesale by a meta rule
        if not _frontier_ready(store, dist, n):
            continue
        diags = diag_by_node.get(n.id, [])
        if diags:
            for dg in diags:
                key = (n.src, dg.category)
                if key in seen_src:
                    continue
                seen_src.add(key)
                sites.append(BugSite(n.src, n.op, n.id, dg.category, dg.detail, dg.repair))
        else:
            key = (n.src, "unverified_frontier")
            if key not in seen_src:
                seen_src.add(key)
                sites.append(
                    BugSite(
                        n.src,
                        n.op,
                        n.id,
                        "unverified_frontier",
                        f"{n.short()} could not be related to any baseline node "
                        f"although all of its inputs are verified",
                    )
                )
        blamed = _blame_twisted_layout(store, dist, n)
        if blamed is not None:
            key = (blamed.src, "layout_mismatch")
            if key not in seen_src:
                seen_src.add(key)
                sites.append(
                    BugSite(
                        blamed.src,
                        blamed.op,
                        blamed.id,
                        "layout_mismatch",
                        f"{blamed.short()} twists the data layout: its input "
                        f"is cleanly related to the baseline but no "
                        f"downstream consumer can use the permuted result",
                    )
                )
    return rank_bug_sites(sites)


def _output_sites(
    base: Graph, dist: Graph, store: RelStore,
    specs: Sequence[OutputSpec], outputs_ok: Sequence[bool],
) -> list[BugSite]:
    """Fallback localization when no frontier site exists: every interior
    node is related, yet an output arrived with the wrong placement — e.g. a
    dropped gradient psum leaves the output a clean *partial* (category-1
    missing collective), or it arrives sharded/twisted where a replicated
    tensor was promised."""
    sites: list[BugSite] = []
    for b, d, spec, ok in zip(base.outputs, dist.outputs, specs, outputs_ok):
        if ok:
            continue
        n = dist[d]
        partial = any(f.kind == PARTIAL and f.base == b for f in store.facts(d))
        if spec.kind == DUP and partial:
            sites.append(BugSite(
                n.src, n.op, n.id, "missing_all_reduce",
                f"output {n.short()} remains a partial {spec.reduce_op}-sum "
                f"over the axis — a reduction collective is missing on its "
                f"producer path"))
        else:
            got = sorted({f.kind for f in store.facts(d) if f.base == b})
            sites.append(BugSite(
                n.src, n.op, n.id, "unverified_frontier",
                f"output {n.short()} expected {spec.kind} placement but "
                f"derived {got or 'no relation'} to the baseline output"))
    return rank_bug_sites(sites)


def verify_graphs(
    base: Graph,
    dist: Graph,
    *,
    size: int,
    input_facts: Sequence[InputFact],
    base_inputs: Sequence[int],
    dist_inputs: Sequence[int],
    output_specs: Optional[Sequence[OutputSpec]] = None,
    options: Optional[VerifyOptions] = None,
    cache: Optional[TemplateCache] = None,
    pool=None,
    timings: Optional[PhaseTimings] = None,
) -> Report:
    """Verify a traced graph pair.

    ``cache``/``pool``/``timings`` are the :class:`repro_torch.verify.Session`
    hooks: a :class:`TemplateCache` valid for this exact graph pair, a
    session-owned thread pool for the worklist engine's parallel sweep, and
    a pre-filled :class:`PhaseTimings` (trace/stamp) this call completes
    with the rules/localize phases."""
    t0 = time.perf_counter()
    options = options or VerifyOptions()
    timings = timings if timings is not None else PhaseTimings()
    if options.engine not in ("worklist", "passes"):
        raise ValueError(f"unknown engine {options.engine!r}: worklist|passes")
    backend = resolve_backend(options)
    prop = Propagator(base, dist, size, axis=options.axis,
                      fusion=options.fusion)
    if options.profile:
        from .report import RuleProfiler

        prop.profiler = RuleProfiler()
    engine = (WorklistEngine(prop, workers=options.parallel_workers,
                             pool=pool, backend=backend,
                             cone_cap=options.chunk_cone_cap,
                             min_offload=options.chunk_min_offload,
                             per_worker=options.chunks_per_worker)
              if options.engine == "worklist" else None)
    for f in input_facts:
        b, d = base_inputs[f.base_index], dist_inputs[f.dist_index]
        if f.kind == DUP:
            prop.register_dup(b, d)
        elif f.kind == SHARD:
            prop.register_shard(b, d, f.dim)
        else:
            raise ValueError(f.kind)
    if (engine is not None and backend == "process"
            and options.parallel_workers > 1):
        engine.start_offload()
    memo = None
    try:
        if options.partition:
            pv = PartitionedVerifier(prop, options.parallel_workers, options.memoize,
                                     engine=engine, cache=cache)
            memo = pv.run()
            if engine is not None:
                # cross-layer cleanup: never-visited nodes plus the pending
                # consumers of facts that crossed layer boundaries (settled
                # memo-hit layers are not re-dispatched)
                engine.run()
            else:
                prop.run(max_passes=2)  # cross-layer cleanup passes
        elif engine is not None:
            engine.run()
        else:
            prop.run(max_passes=options.max_passes)
    finally:
        if engine is not None:
            engine.close()
    t_rules = time.perf_counter()
    timings.rules_s = t_rules - t0
    if prop.profiler is not None:
        timings.profile = prop.profiler.summary()

    specs = list(output_specs or [OutputSpec()] * len(dist.outputs))
    outputs_ok = [
        _output_ok(prop.store, b, d, s, size)
        for b, d, s in zip(base.outputs, dist.outputs, specs)
    ]
    verified = all(outputs_ok)
    sites = [] if verified else localize(base, dist, prop.store)
    if not verified and not sites:
        sites = _output_sites(base, dist, prop.store, specs, outputs_ok)
    unverified = sum(
        1 for n in dist if n.op not in LEAF_OPS and not prop.store.verified(n.id)
    )
    timings.localize_s = time.perf_counter() - t_rules
    return Report(
        verified=verified,
        outputs_ok=outputs_ok,
        bug_sites=sites,
        diagnostics=prop.store.diagnostics,
        num_facts=prop.store.num_derived,
        num_base_nodes=len(base.nodes),
        num_dist_nodes=len(dist.nodes),
        elapsed_s=time.perf_counter() - t0,
        memo=memo,
        unverified_count=unverified,
        rule_invocations=prop.rule_invocations,
        timings=timings,
        cache=CacheStats.from_memo(memo),
        egraph=prop.fusion.stats() if prop.fusion is not None else None,
    )


def verify_sharded(
    base_fn,
    dist_fn,
    *args,
    axis: str = "model",
    size: int = 4,
    in_specs: Sequence = (),
    output_specs: Optional[Sequence[OutputSpec]] = None,
    options: Optional[VerifyOptions] = None,
) -> Report:
    """Trace ``base_fn(*args)`` (single-device) and ``dist_fn(ctx, *args)``
    (the per-rank program, collectives explicit, under a fake process group
    of ``size`` ranks) and verify equivalence.

    ``args`` are global shapes (tensors or ``ShapeDtype``s); ``in_specs``
    holds one spec tree per argument (``repro_torch.parallel.sharding.P``)
    and doubles as the *input relation registration*: a spec that shards dim
    d along ``axis`` registers ``sharded(b_i, d_i, dim=d)``; a replicated
    spec registers ``duplicate``.
    """
    from repro_torch.parallel.sharding import is_spec
    from repro_torch.tree import tree_leaves
    from repro_torch.verify.specs import spec_input_facts

    options = options or VerifyOptions(axis=axis)
    gb, b_in, _b_out = trace(base_fn, *args, name="base")
    gd, d_in, _d_out = trace_sharded(dist_fn, size, tuple(in_specs), *args,
                                     axis=axis, name="dist")
    leaves = tree_leaves(tuple(in_specs), is_leaf=is_spec)
    return verify_graphs(
        gb,
        gd,
        size=size,
        input_facts=spec_input_facts(leaves, axis=axis),
        base_inputs=b_in,
        dist_inputs=d_in,
        output_specs=output_specs,
        options=options,
    )
