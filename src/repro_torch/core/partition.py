"""Two-step graph partitioning, parallel rewriting and layer memoization
(paper §5.1, Algorithm 1).

Layers come from ``layer`` tags assigned at trace time (``jax.named_scope
("layer<i>")`` in the model code — the natural cut points the paper uses).
Within a layer, nodes are grouped into **topological stages**; independent
subtopologies of a stage are rewritten on a thread pool (``T1..Tn`` of
Fig. 5).  Structurally identical layer pairs with identical input-relation
signatures are **memoized**: their facts are replayed onto the new layer's
nodes without re-running rule matching — the dominant cost saving for deep
models (paper Fig. 12).

On **stamped** graphs (``repro.core.stamp``) the per-layer bookkeeping is
O(layer boundary) instead of O(layer): stamped periods are literal clones of
the template period, so their structural fingerprints, slice-offset deltas
and external-input lists are served from a per-template cache instead of
being recomputed, and a memo hit *settles* the layer in the worklist engine
— replayed facts mark only boundary consumers and the final cleanup run
never re-dispatches the layer's nodes.
"""
from __future__ import annotations

import concurrent.futures as _fut
from dataclasses import dataclass, field
from typing import Optional, Sequence

from .ir import Graph
from .rules import Propagator


@dataclass
class LayerPlan:
    key: Optional[int]  # layer tag (None = preamble/postamble pseudo-layers)
    base_nodes: list[int]
    dist_nodes: list[int]


def split_layer_buckets(g: Graph) -> dict:
    """Bucket node ids by layer tag, in topological (id) order: ``"pre"`` =
    untagged before the first tagged node, int tags, ``"post"`` = untagged
    after the last.  Untagged *interior* nodes attach to the tag last seen
    in node-id order (the topologically previous layer — NOT the
    numerically largest tag, which differs when tags interleave)."""
    tagged = [n.id for n in g if n.layer is not None]
    first = tagged[0] if tagged else len(g.nodes)
    last = tagged[-1] if tagged else -1
    buckets: dict = {"pre": [], "post": []}
    last_tag: Optional[int] = None
    for n in g:
        if n.layer is not None:
            last_tag = n.layer
            buckets.setdefault(n.layer, []).append(n.id)
        elif n.id < first:
            buckets["pre"].append(n.id)
        elif n.id > last:
            buckets["post"].append(n.id)
        else:
            # untagged interior node: attach to the previous tagged layer
            buckets.setdefault(last_tag if last_tag is not None else "pre",
                               []).append(n.id)
    return buckets


def partition_layers(base: Graph, dist: Graph) -> list[LayerPlan]:
    """Partition both graphs along layer boundaries, preserving topological
    order: preamble (untagged before the first tagged node), layers by tag,
    postamble (untagged after)."""
    b, d = split_layer_buckets(base), split_layer_buckets(dist)
    keys = sorted({k for k in list(b) + list(d) if isinstance(k, int)})
    plans = [LayerPlan("pre", b.get("pre", []), d.get("pre", []))]
    plans += [LayerPlan(k, b.get(k, []), d.get(k, [])) for k in keys]
    plans.append(LayerPlan("post", b.get("post", []), d.get("post", [])))
    return plans


def topological_stages(g: Graph, nids: Sequence[int]) -> list[list[int]]:
    """Split a subgraph into stages: each stage's nodes depend only on nodes
    in earlier stages or outside the subgraph (boundary nodes, Fig. 5)."""
    inside = set(nids)
    depth: dict[int, int] = {}
    for nid in sorted(nids):
        d = 0
        for i in g[nid].inputs:
            if i in inside:
                d = max(d, depth[i] + 1)
        depth[nid] = d
    stages: dict[int, list[int]] = {}
    for nid, d in depth.items():
        stages.setdefault(d, []).append(nid)
    return [sorted(stages[k]) for k in sorted(stages)]


def stage_topologies(g: Graph, stage: Sequence[int]) -> list[list[int]]:
    """Independent subtopologies within a stage (parallel rewriting units).

    Stage nodes have no intra-stage edges by construction, so group them by
    shared *inputs* to keep cache locality; singleton groups otherwise."""
    groups: dict[int, list[int]] = {}
    for nid in stage:
        key = g[nid].inputs[0] if g[nid].inputs else nid
        groups.setdefault(key, []).append(nid)
    return list(groups.values())


@dataclass
class MemoStats:
    layers: int = 0
    memo_hits: int = 0
    facts_replayed: int = 0
    # template fast path: fingerprints/ext-input lists served from a cache
    # (stamped periods within a run, every layer on a warm Session re-verify),
    # and dist nodes settled without a cleanup re-dispatch
    fp_cached: int = 0
    settled_nodes: int = 0


@dataclass
class TemplateCache:
    """Cross-run template cache owned by a :class:`repro.verify.Session`.

    Valid ONLY for re-verification of the *identical* graph pair (the
    session keys it together with its trace cache): ``memo`` holds the
    per-layer fact templates, ``tpl`` the stamped-period structure cache,
    and ``struct`` the per-layer structural parts keyed by plan key —
    ``plan.key -> (base_fp, dist_fp, slice_delta, base_ext, dist_ext)`` —
    so a warm re-verify never re-fingerprints a layer."""

    memo: dict = field(default_factory=dict)
    tpl: dict = field(default_factory=dict)
    struct: dict = field(default_factory=dict)


def delta_template_cache(cache: TemplateCache, delta, old_dist: Graph,
                         dist: Graph) -> TemplateCache:
    """Template-cache view for *delta re-verification* of a mutated graph.

    ``cache`` is the clean pair's TemplateCache, ``delta`` a
    :class:`~repro.core.ir.GraphDelta` from ``old_dist`` (the clean dist
    graph) to ``dist`` (the mutated one — ``delta.changed`` ids live in its
    id space).  The returned cache is safe to use verbatim on the mutated
    pair:

    * ``memo`` entries are **content-addressed positional templates** —
      keyed on normalized structural fingerprints + input-fact signatures,
      replayed by zipping source ids onto the target plan's nodes — so
      they carry over as-is (a changed layer's recomputed fingerprint can
      never match a clean entry; an unchanged layer's replay is exactly
      the from-scratch derivation).  A dict copy keeps new entries derived
      from the mutated graph out of the clean cache.
    * ``struct`` entries are keyed on plan keys and store node-id lists in
      the clean graph's id space: entries for layers overlapping the
      changed region — in *either* id space, so a pure deletion (whose
      ``changed`` set in the new space may miss the vanished node itself)
      still invalidates the layer it was deleted from — are dropped (their
      fingerprints must be recomputed) and surviving dist ext-input ids are
      remapped through the delta.
    * ``tpl`` is cleared: stamped-clone shortcuts assume the stamp
      metadata matches the graph, and mutated graphs run unstamped.
    """
    changed = set(delta.changed)
    bad = {k for k, nids in split_layer_buckets(dist).items()
           if not changed.isdisjoint(nids)}
    deleted = set(range(delta.prefix, delta.old_end))
    if deleted:
        bad |= {k for k, nids in split_layer_buckets(old_dist).items()
                if not deleted.isdisjoint(nids)}
    struct = {}
    for k, v in cache.struct.items():
        if k in bad:
            continue
        b_fp, d_fp, sdelta, bext, dext = v
        nd = [delta.map_old(e) for e in dext]
        if any(e is None for e in nd):
            continue  # ext input fell inside the edited region
        struct[k] = (b_fp, d_fp, sdelta, bext, nd)
    return TemplateCache(memo=dict(cache.memo), tpl={}, struct=struct)


class PartitionedVerifier:
    """Runs Algorithm 1: per-layer-pair registration, staged parallel
    rewriting, memoized replay for repeated layers."""

    def __init__(self, prop: Propagator, parallel_workers: int = 0, memoize: bool = True,
                 engine=None, cache: Optional[TemplateCache] = None):
        self.prop = prop
        self.workers = parallel_workers
        self.memoize = memoize
        self.engine = engine  # WorklistEngine: semi-naive per-layer rewriting
        self.stats = MemoStats()
        # memo: fingerprint -> (base_nodes, dist_nodes, base_ext, [fact templates])
        self._memo: dict[tuple, tuple] = cache.memo if cache else {}
        # stamped fast path: template tag -> (b_struct, d_struct, delta,
        #                                     base_ext, dist_ext)
        self._tpl_cache: dict[int, tuple] = cache.tpl if cache else {}
        # cross-run structural parts (warm Session re-verify of the SAME
        # graph pair); None disables the lookup so cold runs are unchanged
        self._struct_cache: Optional[dict] = cache.struct if cache else None

    # -- signatures -----------------------------------------------------------
    def _ext_inputs(self, g: Graph, nids: Sequence[int]) -> list[int]:
        inside = set(nids)
        ext, seen = [], set()
        for nid in sorted(nids):
            for i in g[nid].inputs:
                if i not in inside and i not in seen:
                    seen.add(i)
                    ext.append(i)
        return ext

    def _stamp_period(self, key) -> Optional[int]:
        """Stamped period index of a plan key, when BOTH graphs are stamped
        and the key lies in a stamped (cloned) period."""
        sb, sd = self.prop.base.stamp, self.prop.dist.stamp
        if sb is None or sd is None or not isinstance(key, int):
            return None
        p = sb.period_of_tag(key)
        if p <= sb.template_period or sd.period_of_tag(key) != p:
            return None
        if sb.total_periods != sd.total_periods or p >= sb.total_periods:
            return None
        return p

    def _plan_ext(self, plan: LayerPlan) -> tuple[list[int], list[int]]:
        """(base_ext, dist_ext) — from the session struct cache on a warm
        re-verify or the stamped template cache (O(boundary)), computed
        exactly otherwise (O(layer))."""
        if self._struct_cache is not None:
            hit = self._struct_cache.get(plan.key)
            if hit is not None:
                self.stats.fp_cached += 1
                return hit[3], hit[4]
        p = self._stamp_period(plan.key)
        if p is not None:
            tpl = self._tpl_cache.get(self.prop.base.stamp.template_tag(plan.key))
            if tpl is not None:
                sb, sd = self.prop.base.stamp, self.prop.dist.stamp
                self.stats.fp_cached += 1
                return ([sb.shift_node(e, p) for e in tpl[3]],
                        [sd.shift_node(e, p) for e in tpl[4]])
        return (self._ext_inputs(self.prop.base, plan.base_nodes),
                self._ext_inputs(self.prop.dist, plan.dist_nodes))

    def _input_signature(self, plan: LayerPlan,
                         ext: Optional[tuple[list[int], list[int]]] = None) -> tuple:
        """Signature of incoming facts on the layer's external dist inputs,
        with baseline nodes encoded positionally (ext-input index)."""
        base_ext, dist_ext = ext if ext is not None else self._plan_ext(plan)
        bpos = {b: i for i, b in enumerate(base_ext)}
        sig = []
        for j, d in enumerate(dist_ext):
            for f in self.prop.store.facts(d):
                if f.base in bpos:
                    sig.append(
                        (j, bpos[f.base], f.kind, f.reduce_op, f.layout.atoms,
                         f.layout.perm, f.layout.dst_groups, f.dim, f.nchunk, f.index)
                    )
        return tuple(sorted(sig))

    def _struct_parts(self, plan: LayerPlan,
                      ext: tuple[list[int], list[int]]) -> tuple:
        """(base_fp, dist_fp, slice-offset delta) — cached for stamped
        periods: clones share the template's structure, and their base/dist
        slice offsets advance in lockstep so the *delta* is invariant."""
        if self._struct_cache is not None:
            hit = self._struct_cache.get(plan.key)
            if hit is not None:
                return hit[0], hit[1], hit[2]
        p = self._stamp_period(plan.key)
        tpl_key = None
        if p is not None:
            tpl_key = self.prop.base.stamp.template_tag(plan.key)
            tpl = self._tpl_cache.get(tpl_key)
            if tpl is not None:
                return tpl[0], tpl[1], tpl[2]
        b_off = self.prop.base.slice_offsets(plan.base_nodes)
        d_off = self.prop.dist.slice_offsets(plan.dist_nodes)
        if len(b_off) == len(d_off):
            delta = tuple(
                tuple(x - y for x, y in zip(d, b)) for b, d in zip(b_off, d_off)
            )
        else:
            delta = (tuple(b_off), tuple(d_off))  # unmatched: raw (no false merge)
        b_fp = self.prop.base.fingerprint(sorted(plan.base_nodes), normalize_slices=True)
        d_fp = self.prop.dist.fingerprint(sorted(plan.dist_nodes), normalize_slices=True)
        # record the template period's parts for its stamped clones
        sb = self.prop.base.stamp
        if (sb is not None and self.prop.dist.stamp is not None
                and isinstance(plan.key, int)
                and sb.period_of_tag(plan.key) == sb.template_period):
            self._tpl_cache[plan.key] = (b_fp, d_fp, delta, ext[0], ext[1])
        if self._struct_cache is not None:
            self._struct_cache[plan.key] = (b_fp, d_fp, delta, ext[0], ext[1])
        return b_fp, d_fp, delta

    def _fingerprint(self, plan: LayerPlan,
                     ext: tuple[list[int], list[int]]) -> tuple:
        """Memoization key: normalized structural hashes of both layer
        subgraphs + incoming-fact signature + the base<->dist slice-offset
        *deltas* (so layer i slicing W[i] on both sides matches layer j
        slicing W[j], but never W[i] vs W[j])."""
        b_fp, d_fp, delta = self._struct_parts(plan, ext)
        return (b_fp, d_fp, self._input_signature(plan, ext), delta)

    # -- replay ------------------------------------------------------------------
    def _replay(self, memo, plan: LayerPlan, dst_bext: list[int]) -> None:
        src_b, src_d, src_bext, facts = memo
        bmap = dict(zip(src_b, plan.base_nodes))
        bmap.update(zip(src_bext, dst_bext))
        dmap = dict(zip(src_d, plan.dist_nodes))
        emit = self.prop.emit
        before = self.prop.store.num_derived
        if self.engine is not None:
            with self.engine.settling(plan.dist_nodes):
                for f in facts:
                    nb, nd = bmap.get(f.base), dmap.get(f.dist)
                    if nb is not None and nd is not None:
                        emit(f.moved(nb, nd))
                if self.prop.fusion is not None:
                    # re-discharge what the memo template excluded: replayed
                    # identity-DUPs re-seed the (global) e-graph and the
                    # settle emits the layer's fusion facts afresh, keeping
                    # warm-run fact sets and downstream layer input
                    # signatures identical to the cold run's
                    self.prop.fusion.settle()
            self.stats.settled_nodes += len(plan.dist_nodes)
        else:
            for f in facts:
                nb, nd = bmap.get(f.base), dmap.get(f.dist)
                if nb is not None and nd is not None:
                    emit(f.moved(nb, nd))
            if self.prop.fusion is not None:
                self.prop.fusion.settle()
        self.stats.facts_replayed += self.prop.store.num_derived - before

    # -- main loop --------------------------------------------------------------
    def run(self) -> MemoStats:
        plans = partition_layers(self.prop.base, self.prop.dist)
        pool = None
        if self.workers > 1 and self.engine is None:
            # one pool for the whole run (pass-engine Fig. 5 path)
            pool = _fut.ThreadPoolExecutor(max_workers=self.workers)
        try:
            for plan in plans:
                if not plan.dist_nodes:
                    continue
                self.stats.layers += 1
                fp = ext = None
                if self.memoize and isinstance(plan.key, int):
                    ext = self._plan_ext(plan)
                    fp = self._fingerprint(plan, ext)
                if fp is not None and fp in self._memo:
                    self.stats.memo_hits += 1
                    self._replay(self._memo[fp], plan, ext[0])
                    continue
                self._rewrite_layer(plan, pool)
                if fp is not None:
                    inside_b = set(plan.base_nodes)
                    ext_b_set = set(ext[0])
                    # fusion-discharged facts (and their closure cascade) are
                    # excluded from the template: they can rest on e-class
                    # merges crossing layer boundaries (content-addressed
                    # leaves are global), so replaying them positionally into
                    # another layer is not covered by the layer-local
                    # fingerprint — the post-replay settle re-derives them
                    fkeys = self.prop.fusion_keys
                    facts = [
                        f
                        for d in plan.dist_nodes
                        for f in self.prop.store.facts(d)
                        if (f.base in inside_b or f.base in ext_b_set)
                        and f.key() not in fkeys
                    ]
                    self._memo[fp] = (sorted(plan.base_nodes),
                                      sorted(plan.dist_nodes), ext[0], facts)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        return self.stats

    def _rewrite_layer(self, plan: LayerPlan, pool=None) -> None:
        if self.engine is not None:
            # semi-naive worklist: seed the layer's nodes once, then re-visit
            # only consumers of changed nodes until the layer reaches fixpoint
            self.engine.run(plan.dist_nodes)
            return
        stages = topological_stages(self.prop.dist, plan.dist_nodes)
        for _round in range(3):  # fixpoint rounds within the layer
            before = self.prop.store.num_derived
            for stage in stages:
                if pool is not None and len(stage) > 8:
                    topos = stage_topologies(self.prop.dist, stage)
                    list(pool.map(lambda t: self.prop.run(t, max_passes=1), topos))
                else:
                    self.prop.run(stage, max_passes=1)
            if self.prop.store.num_derived == before:
                break
