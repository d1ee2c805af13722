"""Semi-naive worklist evaluation (egg/TTrace-style incremental rules).

The pass-based reference engine rescans every node on every pass —
O(passes x nodes) handler firings even when a single fact changed.  The
worklist engine visits each node once and then re-visits a node only when
one of its *inputs* gained a fact: :meth:`RelStore.add` notifies a listener
with each batch of new facts, which enqueues the dist-graph consumers of
the changed nodes (via the precomputed consumer index on
:class:`~repro.core.ir.Graph`), tagged with the fact kinds that changed so
rules that never consume those kinds are skipped (the ``consumes``
declaration on each registered rule).

Restricted runs (``run(nodes=layer_nodes)``) drive per-layer rewriting in
:class:`~repro.core.partition.PartitionedVerifier`: facts crossing the
layer boundary land in ``pending`` and are drained by a later run — the
final unrestricted ``run()`` visits only never-visited nodes plus the
pending frontier, never the whole graph again.  Memo-hit layers are
**settled** (:meth:`settling`): their replayed facts mark only consumers
*outside* the layer, and the layer's nodes count as visited — the memo
already captured the layer's fixpoint, so re-dispatching its rules would
derive nothing.

With ``workers > 1`` a restricted run's initial sweep executes the paper's
Fig. 5 parallel rewriting: the layer's topological stages are split into
independent subtopologies dispatched on a persistent thread pool.  Each
shard evaluates against a read-through overlay store (committed facts are
frozen for the duration of a stage) and the overlays are merged through a
single :meth:`RelStore.add_batch` per shard — rule matching never observes
a half-written store.  The serial drain then runs the incremental tail to
fixpoint, so verdicts and fact sets are identical to a serial run.

``rule_invocations`` mirrors the Propagator's counter; benchmarks compare
it against the pass-based engine's count on the same graph pair
(``benchmarks/bench_propagation.py``).
"""
from __future__ import annotations

import concurrent.futures as _fut
import heapq
from contextlib import contextmanager
from typing import Iterable, Optional

from ..relations import _KIND_BITS, KIND_ID, Diagnostic, Fact, RelStore

# minimum seeded nodes before a restricted run fans out on the pool
_PARALLEL_MIN_NODES = 24

# partition helpers, bound lazily on first parallel sweep: a module-level
# import would be circular (partition.py imports this package), so they are
# hoisted into module globals once instead of re-imported on every sweep
_stage_topologies = None
_topological_stages = None


def _partition_helpers():
    global _stage_topologies, _topological_stages
    if _stage_topologies is None:
        from ..partition import stage_topologies, topological_stages

        _stage_topologies = stage_topologies
        _topological_stages = topological_stages
    return _stage_topologies, _topological_stages


def fork_available() -> bool:
    import multiprocessing

    return "fork" in multiprocessing.get_all_start_methods()


def _process_pool(workers: int) -> _fut.ProcessPoolExecutor:
    """Worker-process pool for the process shard backend.  Prefers the fork
    context: workers inherit the already-imported rule modules instead of
    re-importing the package (which would drag jax in under spawn)."""
    import multiprocessing

    ctx = (multiprocessing.get_context("fork")
           if fork_available() else multiprocessing.get_context())
    return _fut.ProcessPoolExecutor(max_workers=workers, mp_context=ctx)


class _ShardStore:
    """Read-through overlay for one parallel shard.

    Reads see the committed store plus this shard's local facts; writes
    buffer locally and are merged (deduplicated) into the committed store
    after the stage barrier.  The committed store is never written while
    shards run, so no locking is needed.
    """

    def __init__(self, committed: RelStore) -> None:
        self._c = committed
        self.by_dist: dict[int, list[Fact]] = {}
        self.by_base: dict[int, list[Fact]] = {}
        # packed-int (node_id << _KIND_BITS) | kind_id keys, mirroring the
        # committed RelStore's columnar indexes — including the (base, kind)
        # overlay its committed counterpart has (facts_for_base_kind used to
        # be an O(n) scan over the merged per-base list)
        self.by_dist_kind: dict[int, list[Fact]] = {}
        self.by_base_kind: dict[int, list[Fact]] = {}
        self._seen: set[tuple] = set()
        self.new_facts: list[Fact] = []
        self.diagnostics: list[Diagnostic] = []
        self.num_derived = committed.num_derived
        self.covered_scopes = committed.covered_scopes
        self.covered_nodes = committed.covered_nodes

    def add(self, fact: Fact) -> bool:
        k = fact.key()
        if k in self._seen or k in self._c._seen:
            return False
        self._seen.add(k)
        kid = KIND_ID[fact.kind]
        self.by_dist.setdefault(fact.dist, []).append(fact)
        self.by_base.setdefault(fact.base, []).append(fact)
        self.by_dist_kind.setdefault((fact.dist << _KIND_BITS) | kid,
                                     []).append(fact)
        self.by_base_kind.setdefault((fact.base << _KIND_BITS) | kid,
                                     []).append(fact)
        self.new_facts.append(fact)
        self.num_derived += 1
        return True

    def facts(self, dist: int) -> list[Fact]:
        loc = self.by_dist.get(dist)
        base = self._c.facts(dist)
        return base + loc if loc else base

    def facts_kind(self, dist: int, kind: str) -> list[Fact]:
        loc = self.by_dist_kind.get((dist << _KIND_BITS) | KIND_ID[kind])
        base = self._c.facts_kind(dist, kind)
        return base + loc if loc else base

    def facts_for_base(self, base: int) -> list[Fact]:
        loc = self.by_base.get(base)
        com = self._c.facts_for_base(base)
        return com + loc if loc else com

    def facts_for_base_kind(self, base: int, kind: str) -> list[Fact]:
        loc = self.by_base_kind.get((base << _KIND_BITS) | KIND_ID[kind])
        com = self._c.facts_for_base_kind(base, kind)
        return com + loc if loc else com

    def verified(self, dist: int) -> bool:
        return bool(self._c.by_dist.get(dist)) or bool(self.by_dist.get(dist))

    def diag(self, dist: int, category: str, detail: str, repair=None) -> None:
        self.diagnostics.append(Diagnostic(dist, category, detail, repair))


class WorklistEngine:
    def __init__(self, prop, workers: int = 0, pool=None,
                 backend: str = "thread", cone_cap: int = 64,
                 min_offload: int = 64, per_worker: int = 3) -> None:
        self.prop = prop
        self.workers = int(workers or 0)
        self.backend = backend
        # process-backend chunk-planning caps (VerifyOptions.chunk_*);
        # consumed by ProcessOffload / plan_chunks
        self.cone_cap = int(cone_cap)
        self.min_offload = int(min_offload)
        self.per_worker = int(per_worker)
        self._ext_pool = pool  # session-owned: survives close()
        self._own_pool = None  # engine-owned: shut down by close()
        self._offload = None  # ProcessOffload when the process backend runs
        self._consumers = prop.dist.consumer_index()
        # nodes to (re)visit outside the active run, kind-tagged
        self.pending: dict[int, set[str]] = {}
        self.visited: set[int] = set()
        self._heap: list[int] = []
        self._inheap: dict[int, Optional[set[str]]] = {}  # None = fire all rules
        self._allowed: Optional[set[int]] = None
        self._active = False
        self._settling: Optional[set[int]] = None
        prop.store.listeners.append(self._on_facts)

    @property
    def rule_invocations(self) -> int:
        return self.prop.rule_invocations

    def _get_pool(self):
        if self._ext_pool is not None:
            return self._ext_pool
        if self._own_pool is None:
            if self.backend == "process":
                self._own_pool = _process_pool(self.workers)
            else:
                self._own_pool = _fut.ThreadPoolExecutor(
                    max_workers=self.workers)
        return self._own_pool

    def close(self) -> None:
        # only the engine-owned pool is shut down; an externally-owned
        # (session) pool is never touched, and no reference to it lingers
        self._offload = None
        if self._own_pool is not None:
            self._own_pool.shutdown(wait=True, cancel_futures=True)
            self._own_pool = None

    # -------------------------------------------------------- process backend
    def start_offload(self) -> None:
        """Process backend: plan the distributed graph's small-cone chunks
        and submit them to the worker pool (see
        :mod:`repro.core.rules.parshard`).  Subsequent :meth:`run` calls
        merge finished chunks before seeding — blocking only on chunks a
        restricted run actually needs."""
        if self.workers > 1 and self._offload is None:
            from .parshard import ProcessOffload

            self._offload = ProcessOffload(self, self._get_pool())

    # ------------------------------------------------------------ listeners
    def _on_facts(self, facts: Iterable[Fact]) -> None:
        settling = self._settling
        for fact in facts:
            for c in self._consumers.get(fact.dist, ()):
                if settling is not None and c in settling:
                    continue
                self._mark(c, fact.kind)

    def _mark(self, nid: int, kind: str) -> None:
        if self._active and (self._allowed is None or nid in self._allowed):
            cur = self._inheap.get(nid, -1)
            if cur == -1:
                heapq.heappush(self._heap, nid)
                self._inheap[nid] = {kind}
            elif cur is not None:
                cur.add(kind)
        else:
            self.pending.setdefault(nid, set()).add(kind)

    # -------------------------------------------------------------- settling
    @contextmanager
    def settling(self, nids: Iterable[int]):
        """Memo replay for a layer: the replayed facts are that layer's
        fixpoint, so consumers *inside* the layer need no re-visit and the
        layer's nodes count as visited.  Facts arriving later (after the
        context exits) still mark the settled nodes semi-naively."""
        prev = self._settling
        self._settling = set(nids)
        try:
            yield
        finally:
            settled, self._settling = self._settling, prev
            self.visited.update(settled)
            for nid in settled:
                self.pending.pop(nid, None)

    # ------------------------------------------------------------------ run
    def run(self, nodes: Optional[Iterable[int]] = None) -> None:
        """Drain the worklist to fixpoint.

        ``nodes`` restricts processing to that subset (per-layer rewriting);
        an unrestricted run seeds every not-yet-visited node plus the
        pending cross-boundary frontier."""
        dist = self.prop.dist
        if self._offload is not None:
            # merge finished chunks first (their nodes then count as
            # visited); block on the chunks this run's nodes depend on —
            # an unrestricted run waits for everything outstanding
            self._offload.drain(nodes if nodes is not None else None)
        if nodes is None:
            allowed = None
            seeds: dict[int, Optional[set[str]]] = {
                n: None for n in range(len(dist.nodes)) if n not in self.visited
            }
        else:
            allowed = set(nodes)
            seeds = {n: None for n in allowed if n not in self.visited}
        if (self.workers > 1 and self.backend != "process"
                and allowed is not None
                and len(seeds) >= _PARALLEL_MIN_NODES):
            self._sweep_parallel(sorted(seeds))
            seeds = {}
        for nid in list(self.pending):
            if allowed is None or nid in allowed:
                kinds = self.pending.pop(nid)
                if seeds.get(nid, -1) == -1:  # not seeded: semi-naive re-visit
                    seeds[nid] = kinds
        self._inheap = dict(seeds)
        self._heap = sorted(seeds)  # min-heap: topological (ids are topo-ordered)
        self._allowed = allowed
        self._active = True
        try:
            while True:
                while self._heap:
                    nid = heapq.heappop(self._heap)
                    if nid not in self._inheap:
                        continue  # superseded entry
                    kinds = self._inheap.pop(nid)
                    self.visited.add(nid)
                    self.prop.dispatch(
                        dist[nid], None if kinds is None else frozenset(kinds)
                    )
                before = self.prop.store.num_derived
                self.prop.apply_meta_rules()
                if self.prop.fusion is not None:
                    # interleave equality saturation with semi-naive
                    # evaluation: fact-seeded merges settle, congruent
                    # classes discharge DUPs (which re-enter via the store
                    # listeners), and the joint fixpoint is reached when
                    # neither side derives anything new
                    self.prop.fusion.settle()
                if not self._heap and self.prop.store.num_derived == before:
                    break
        finally:
            self._active = False
            self._allowed = None

    # ------------------------------------------------------- parallel sweep
    def _sweep_parallel(self, nids: list[int]) -> None:
        """Initial visit of a restricted run on the thread pool (Fig. 5):
        stage by stage, independent subtopologies evaluate against overlay
        stores merged through one add_batch per shard.  Facts derived here
        mark consumers into ``pending``; the serial drain finishes the
        incremental tail."""
        stage_topologies, topological_stages = _partition_helpers()
        pool = self._get_pool()
        prop, dist = self.prop, self.prop.dist
        prop.prewarm_shared()
        store = prop.store
        for stage in topological_stages(dist, nids):
            self.visited.update(stage)
            shards = stage_topologies(dist, stage) if len(stage) > 2 else [list(stage)]
            if len(shards) < 2 or len(stage) < 8:
                for nid in stage:
                    prop.dispatch(dist[nid])
            else:
                def run_shard(shard_nids: list[int]):
                    sprop = prop.shard_clone(_ShardStore(store))
                    for nid in shard_nids:
                        sprop.dispatch(dist[nid])
                    return sprop

                for sprop in list(pool.map(run_shard, shards)):
                    store.add_batch(sprop.store.new_facts)
                    store.diagnostics.extend(sprop.store.diagnostics)
                    prop.rule_invocations += sprop.rule_invocations
                    if prop.profiler is not None:
                        prop.profiler.merge(sprop.profiler)
            # marks targeting this stage came from earlier stages' facts,
            # which the dispatch above already saw: drop them so the serial
            # drain doesn't re-visit the whole layer (facts derived in THIS
            # stage only ever mark strictly later stages — no intra-stage
            # edges — so nothing is lost)
            for nid in stage:
                self.pending.pop(nid, None)
