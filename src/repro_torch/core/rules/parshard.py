"""Process-backend parallel rewriting: picklable shard work units.

The thread backend (``engine._sweep_parallel``) shards a layer's stage
subtopologies across threads — cheap to ship (shards see the parent's
store through an overlay) but GIL-bound: rule matching is pure Python, so
four threads rewrite no faster than one.

This module makes the Fig. 5 parallel sweep *actually* parallel by moving
shard evaluation into worker **processes**.  A live ``Propagator`` clone
cannot cross a process boundary (it drags the graphs, e-graph and caches
through pickle on every task), so work units are reduced to data:

* **chunk planning** (parent, once per verify): the distributed graph's
  *small-cone* nodes — nodes whose entire input cone (leaves excluded)
  fits under a size cap — are grouped into connected components and packed
  into chunks.  In transformer traces these are exactly the per-layer
  weight-preparation chains (slice/reshape/transpose pipelines off the
  parameter tensors), ~40-50% of all nodes, each chain independent of the
  serial residual spine;
* **work unit** = ``(pair token, chunk node ids, compact fact snapshot)``
  — the snapshot is the facts of the chunk's external inputs (graph
  leaves), the only facts a chunk evaluation can consume;
* **pair payload**: the graphs themselves are pickled once per verify and
  cached worker-side under the token, with a miss-retry protocol for pool
  reuse across verifies (``Session`` owns one persistent pool);
* **merge**: each finished chunk merges through one batched
  ``RelStore.add_batch`` inside ``engine.settling(chunk)`` — replayed
  facts mark only consumers *outside* the chunk (the chunk is at its
  internal fixpoint), preserving exact verdict/fact-set parity with the
  serial engine.

The parent pipelines its own serial drain (the residual spine, meta rules,
localization) against the workers chewing the offloaded cones; before a
restricted per-layer run it blocks only on the chunks intersecting that
layer, which the (much faster) workers have almost always finished.

Fact keys are process-local (they intern layout ids): workers ship
``Fact``/``Layout`` objects whose ``__reduce__`` re-interns them on
arrival, and the parent re-keys during ``add_batch`` — keys never cross
the boundary.
"""
from __future__ import annotations

import pickle
from typing import Iterable, Optional

from ..ir import Graph
from ..relations import Fact

# cone-size cap: a node is offloadable when its whole input cone (leaves
# excluded) has at most this many nodes.  Weight-preparation chains sit far
# below it; the residual spine blows through it within a few nodes.
_CONE_CAP = 64
# minimum offloadable nodes before process fan-out pays for itself
_MIN_OFFLOAD_NODES = 64
# worker-side pair cache entries (persistent pools serve many verifies)
_PAIR_CACHE_MAX = 4


# --------------------------------------------------------------------------
# worker side


_PAIRS: dict = {}  # token -> Propagator (per worker process)

# parent-side token allocator: tokens must be unique across every verify a
# persistent pool serves (id() values can be recycled by the allocator, so
# they are not safe cache keys)
_TOKEN_SEQ = 0


def _next_token() -> tuple:
    global _TOKEN_SEQ
    _TOKEN_SEQ += 1
    return ("pair", _TOKEN_SEQ)


def _pair_propagator(token, payload: Optional[bytes]):
    prop = _PAIRS.get(token)
    if prop is not None or payload is None:
        return prop
    from .propagator import Propagator

    base, dist, size, axis = pickle.loads(payload)
    prop = Propagator(base, dist, size, axis=axis)
    if len(_PAIRS) >= _PAIR_CACHE_MAX:
        _PAIRS.pop(next(iter(_PAIRS)))
    _PAIRS[token] = prop
    return prop


def _eval_chunk(token, payload: Optional[bytes], nids: list,
                snapshot: list):
    """Evaluate one chunk to its local fixpoint; returns
    ``(status, facts, diagnostics, rule_invocations)``.

    ``status`` is ``"miss"`` when the pair is not cached here and no
    payload was sent — the parent retries with the payload attached."""
    prop = _pair_propagator(token, payload)
    if prop is None:
        return ("miss", None, None, 0)
    store = prop.store
    for f in snapshot:  # already closure-completed by the parent: plain add
        store.add(f)
    new: list[Fact] = []
    store.listeners.append(new.extend)
    inv0 = prop.rule_invocations
    diag0 = len(store.diagnostics)
    try:
        prop.run_worklist(nids)
    finally:
        store.listeners.remove(new.extend)
    return ("ok", new, store.diagnostics[diag0:],
            prop.rule_invocations - inv0)


# --------------------------------------------------------------------------
# parent side


def plan_chunks(dist: Graph, workers: int, *, cone_cap: int = _CONE_CAP,
                min_offload: int = _MIN_OFFLOAD_NODES,
                per_worker: int = 3) -> list[list[int]]:
    """Pack the graph's small-cone components into per-worker chunks.

    Returns chunk node-id lists (each topologically sorted), ordered by
    first node id so chunk completion roughly tracks the parent's own
    front-to-back layer order.  Leaves are excluded — the parent dispatches
    them up front so every chunk's external inputs already carry facts.
    The caps default to the module constants but are normally threaded in
    from ``VerifyOptions.chunk_cone_cap`` / ``chunk_min_offload`` /
    ``chunks_per_worker`` via the engine."""
    cone: dict[int, int] = {}
    region: list[int] = []
    big = cone_cap + 1
    for n in dist:
        if not n.inputs:
            cone[n.id] = 0  # leaf: free connector, dispatched by the parent
            continue
        c = 1
        for i in n.inputs:
            c += cone.get(i, big)
            if c > cone_cap:
                c = big
                break
        cone[n.id] = c
        if c <= cone_cap:
            region.append(n.id)
    if len(region) < min_offload:
        return []
    # union-find components over region-internal edges (leaves are shared
    # connectors, not edges: two weight chains touching the same parameter
    # tensor stay independent)
    inside = set(region)
    parent = {nid: nid for nid in region}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for nid in region:
        for i in dist[nid].inputs:
            if i in inside:
                ra, rb = find(nid), find(i)
                if ra != rb:
                    parent[rb] = ra
    comps: dict[int, list[int]] = {}
    for nid in region:  # region is id-ordered -> components stay sorted
        comps.setdefault(find(nid), []).append(nid)
    # pack components into ~per_worker chunks per worker (pipelining
    # granularity)
    target = max(1, (len(region) + per_worker * workers - 1)
                 // (per_worker * workers))
    chunks: list[list[int]] = []
    cur: list[int] = []
    for comp in sorted(comps.values(), key=lambda c: c[0]):
        cur.extend(comp)
        if len(cur) >= target:
            chunks.append(cur)
            cur = []
    if cur:
        chunks.append(cur)
    return chunks


class ProcessOffload:
    """Parent-side manager for one verify call's offloaded chunks."""

    def __init__(self, engine, pool) -> None:
        self._engine = engine
        self._pool = pool
        prop = engine.prop
        self._prop = prop
        dist = prop.dist
        self.chunks = plan_chunks(
            dist, max(2, engine.workers),
            cone_cap=getattr(engine, "cone_cap", _CONE_CAP),
            min_offload=getattr(engine, "min_offload", _MIN_OFFLOAD_NODES),
            per_worker=getattr(engine, "per_worker", 3))
        self.offloaded: set[int] = {n for c in self.chunks for n in c}
        self._tasks: list = []  # (future, chunk_index)
        # finished-but-unmerged results: facts/diagnostics buffer here until
        # a drain needs their nodes (or the final unrestricted drain) — a
        # chunk can straddle layers, and merging a node's facts before the
        # partitioner decides to memo-replay its layer would break fact-set
        # parity with the serial engine (see drain)
        self._buf_facts: list = []
        self._buf_diags: list = []
        self._done_nodes: set[int] = set()
        if not self.chunks:
            return
        # graphs ship without trace-time caches or stamp metadata (workers
        # rebuild the consumer index; the stamp only drives partitioning,
        # which stays in the parent)
        self._token = _next_token()
        self._payload = pickle.dumps(
            (_strip(prop.base), _strip(dist), prop.size, prop.axis),
            protocol=pickle.HIGHEST_PROTOCOL)
        self._sent_payload = 0
        # the chunks' external inputs are graph leaves: dispatch them now so
        # every chunk snapshot is complete before submission
        for n in dist:
            if not n.inputs and n.id not in engine.visited:
                prop.dispatch(n)
                engine.visited.add(n.id)
        for ci, chunk in enumerate(self.chunks):
            self._submit(ci, chunk)

    def _snapshot(self, chunk: list[int]) -> list[Fact]:
        inside = set(chunk)
        store, dist = self._prop.store, self._prop.dist
        out: list[Fact] = []
        seen: set[int] = set()
        for nid in chunk:
            for i in dist[nid].inputs:
                if i not in inside and i not in seen:
                    seen.add(i)
                    out.extend(store.facts(i))
        return out

    def _submit(self, ci: int, chunk: list[int]) -> None:
        # the first `workers` tasks carry the pair payload so every worker
        # process can seed its cache; later tasks send the token alone and
        # fall back to a payload retry on a cache miss
        payload = None
        if self._sent_payload < max(2, self._engine.workers):
            payload = self._payload
            self._sent_payload += 1
        fut = self._pool.submit(_eval_chunk, self._token, payload, chunk,
                                self._snapshot(chunk))
        self._tasks.append((fut, ci))

    # -------------------------------------------------------------- merging
    def drain(self, allowed: Optional[Iterable[int]] = None) -> None:
        """Merge finished chunk results for the nodes ``allowed`` needs;
        block on outstanding chunks intersecting it (``None`` = block on and
        merge everything).

        Merging is *per node*, not per chunk: results buffer until a drain
        actually needs their nodes.  Two filters preserve exact fact-set
        parity with the serial engine:

        * facts on nodes the parent already **visited** are dropped — for a
          memo-replayed layer the replayed template is the canonical serial
          fact set, and a worker's full-context evaluation can soundly
          derive *more* (e.g. cross-layer congruence pairings through the
          emit closure) than the template ever records;
        * facts on nodes outside ``allowed`` stay buffered, so a chunk that
          straddles layers cannot leak a node's facts into the store before
          the partitioner decides whether that node's layer memo-replays.
        """
        needed = None if allowed is None else set(allowed)
        remaining = []
        for fut, ci in self._tasks:
            chunk = self.chunks[ci]
            must = needed is None or not needed.isdisjoint(chunk)
            if not must and not fut.done():
                remaining.append((fut, ci))
                continue
            status, facts, diags, inv = fut.result()
            if status == "miss":  # pool recycled the process: retry w/ payload
                fut2 = self._pool.submit(_eval_chunk, self._token,
                                         self._payload, chunk,
                                         self._snapshot(chunk))
                if must:
                    status, facts, diags, inv = fut2.result()
                else:
                    remaining.append((fut2, ci))
                    continue
            self._buf_facts.extend(facts)
            self._buf_diags.extend(diags)
            self._done_nodes.update(chunk)
            self._prop.rule_invocations += inv
        self._tasks = remaining
        engine, prop = self._engine, self._prop
        if needed is None:
            mergeable = self._done_nodes
            take_f, keep_f = self._buf_facts, []
            take_d, keep_d = self._buf_diags, []
        else:
            mergeable = self._done_nodes & needed
            take_f, keep_f = [], []
            for f in self._buf_facts:
                (take_f if f.dist in needed else keep_f).append(f)
            take_d, keep_d = [], []
            for d in self._buf_diags:
                (take_d if d.dist in needed else keep_d).append(d)
        visited = engine.visited
        take_f = [f for f in take_f if f.dist not in visited]
        take_d = [d for d in take_d if d.dist not in visited]
        if take_f or mergeable:
            # a pending mark on a chunk node means the parent derived a fact
            # (e.g. through a meta rule) AFTER the chunk's snapshot was
            # taken: the worker's fixpoint is stale for that node.  Settling
            # would discard the mark — preserve it so the serial drain
            # re-dispatches the node semi-naively and derives what the
            # worker could not see.
            stale = {nid: set(kinds) for nid in mergeable
                     if (kinds := engine.pending.get(nid))}
            with engine.settling(mergeable):
                prop.store.add_batch(take_f)
            for nid, kinds in stale.items():
                for k in kinds:
                    engine._mark(nid, k)
            prop.store.diagnostics.extend(take_d)
        self._buf_facts, self._buf_diags = keep_f, keep_d
        self._done_nodes = self._done_nodes - mergeable
        self.offloaded.difference_update(mergeable)


def _strip(g: Graph) -> Graph:
    out = Graph(g.name)
    out.nodes = g.nodes
    out.outputs = g.outputs
    return out
