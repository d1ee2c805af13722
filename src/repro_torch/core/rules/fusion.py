"""The equality-saturation fusion tier: e-graph ⇄ relational engine.

The paper's core technique is equality saturation *augmented with*
Datalog-style reasoning (egglog's architecture).  This module is the glue
that fuses the two layers into one joint fixpoint:

* **facts seed merges** — every identity-``DUP`` fact emitted by the
  relational rules merges its base/dist node pair in one shared
  :class:`~repro.core.egraph.EGraph` (an identity dup *is* a per-rank
  equality); ``DUP``/``SHARD`` facts relating two dist nodes to the same
  base node under the same layout merge the two dist nodes (both equal the
  same function of the base value);
* **merges discharge facts** — whenever a class ends up holding both a base
  and a dist member with matching (shape, dtype), the pair is a proven
  duplicate and the tier emits the identity-``DUP`` fact *without any
  relational rule firing*.  Congruence closure plus the structural rewrite
  set (layout-chain normalization, collective algebra) does the reasoning
  the retired bespoke rules (``iota_congruence``, ``axis_index_congruence``
  — see :mod:`repro.core.rules.legacy`) used to do one node pair at a time.

The engines call :meth:`FusionTier.settle` at the end of every evaluation
round (worklist settling / reference-engine pass), so saturation and
semi-naive evaluation interleave: rules → facts → merges → congruence
rebuild → discharged facts → more rule firings, until neither side derives
anything new.  Structural saturation itself runs exactly once, at view
construction — the rewrites condition on graph structure only and deposit
canonical hashconsed e-nodes, so congruence closure carries their
consequences through every later merge.  Termination: merges only shrink
the class count, and discharge emissions dedupe through the fact store.

Memo soundness: every fact emitted under a discharge (including the
baseline layout-closure facts it cascades into) is recorded in
``prop.fusion_keys``.  The layer memoizer excludes those keys from its
templates — a discharge may rest on merges that cross layer boundaries
(content-addressed leaves are shared across all layers), so replaying it
positionally into another layer is not justified by the layer-local
fingerprint.  Replayed layers re-derive them instead: the replayed seed
facts re-seed the (global, monotone) e-graph and the post-replay settle
re-discharges the analogous pairs.
"""
from __future__ import annotations

import copy
from collections import OrderedDict

from ..bijection import Layout
from ..egraph import EGraph, GraphEGraph
from ..relations import DUP, SHARD, Fact

# pristine saturated e-graph states, keyed per (graph pair, axis, size).
# Building + saturating the two views over a real model pair costs hundreds
# of milliseconds; a Session re-verifies the SAME traced Graph objects on
# warm calls, so each tier clones the pristine state (milliseconds) instead.
# Entries hold strong graph refs, so an id() key can never alias a freed
# graph; the LRU bound keeps the footprint to a handful of model pairs.
_PRISTINE: OrderedDict = OrderedDict()
_PRISTINE_MAX = 8


def _pristine(prop):
    key = (id(prop.base), id(prop.dist), prop.axis, prop.size)
    hit = _PRISTINE.get(key)
    if hit is not None and hit[0] is prop.base and hit[1] is prop.dist:
        _PRISTINE.move_to_end(key)
        return hit
    eg = EGraph()
    views = tuple(
        GraphEGraph(g, egraph=eg, tag=tag, axis=prop.axis,
                    axis_size=prop.size, content_leaves=True)
        for g, tag in ((prop.base, "b"), (prop.dist, "d")))
    members: dict[int, list[tuple]] = {}
    for view, is_dist in zip(views, (False, True)):
        g = view.graph
        for nid in view.node_class:
            n = g[nid]
            members.setdefault(view.cls(nid), []).append(
                (is_dist, nid, n.op, n.shape, n.dtype, n.layer))
    hit = (prop.base, prop.dist, eg, views[0], views[1], members)
    _PRISTINE[key] = hit
    while len(_PRISTINE) > _PRISTINE_MAX:
        _PRISTINE.popitem(last=False)
    return hit


class FusionTier:
    """One shared e-graph over (base, dist) plus the bidirectional wiring."""

    def __init__(self, prop) -> None:
        self.prop = prop
        _, _, eg0, bview0, dview0, members0 = _pristine(prop)
        self.eg = eg0.clone()
        # shallow view copies: node_class/_chain/_leaf_enodes are read-only
        # after construction, only the EGraph binding must be private
        self.base_view = copy.copy(bview0)
        self.dist_view = copy.copy(dview0)
        self.base_view.eg = self.dist_view.eg = self.eg
        # root class -> [(is_dist, nid, op, shape, dtype, layer)], maintained
        # across merges via the EGraph.on_merge hook
        self.members: dict[int, list[tuple]] = {
            root: list(ms) for root, ms in members0.items()}
        # classes whose membership changed since the last discharge scan.
        # Start with every mixed class: content-addressed leaves (iota,
        # off-axis axis_index, consts) merge at construction, and their
        # first discharge is exactly what the retired congruence rules
        # derived.
        self.dirty: set[int] = set()
        for root, ms in self.members.items():
            kinds = {m[0] for m in ms}
            if len(kinds) == 2:
                self.dirty.add(root)
        self.eg.on_merge = self._on_merge
        self._pending: list[tuple[int, int]] = []  # fact-seeded merges
        self._group_reps: dict[tuple, int] = {}  # fact key sans dist -> dist nid
        # (base nid, dist nid) pairs already discharged or skipped: classes
        # are re-scanned every time membership grows, so without this memo
        # the cross-pair loop re-prices the same pairs on every settle
        self._done_pairs: set[tuple[int, int]] = set()
        # discharge-emitted fact keys (shared object with prop.fusion_keys)
        self.fact_keys: set = prop.fusion_keys
        self.seeded = 0      # fact-seeded merges that actually united classes
        self.discharged = 0  # DUP facts emitted without a rule firing
        prop.store.listeners.append(self._on_facts)
        for facts in list(prop.store.by_dist.values()):
            self._on_facts(facts)  # catch up on pre-tier facts

    # ------------------------------------------------------------- listeners
    def _on_merge(self, kept: int, absorbed: int) -> None:
        ms = self.members.pop(absorbed, None)
        if ms:
            self.members.setdefault(kept, []).extend(ms)
        self.dirty.add(kept)

    def _on_facts(self, facts) -> None:
        """Queue e-class merges implied by new facts (applied at settle —
        never mutate the e-graph from inside a store listener, emission may
        be mid-rule)."""
        b_cls = self.base_view.node_class
        d_cls = self.dist_view.node_class
        pending = self._pending
        reps = self._group_reps
        bg, dg = self.prop.base, self.prop.dist
        for f in facts:
            kind = f.kind
            if kind != DUP and kind != SHARD:
                # PARTIAL/SLICEGRP/LOOPRED relate *aggregates* of the rank
                # tuple, not per-rank values: no per-node equality to seed
                continue
            dc = d_cls.get(f.dist)
            if dc is None:
                continue
            if kind == DUP and f.layout.effectively_identity:
                bc = b_cls.get(f.base)
                if bc is not None and bg[f.base].shape == dg[f.dist].shape:
                    pending.append((bc, dc))
            # two dist nodes related to one base node by the same
            # (kind, layout, aux) are equal to each other per rank
            k = f.key()
            gk = (k[0], k[1]) + k[3:]
            rep = reps.setdefault(gk, f.dist)
            if rep != f.dist:
                pending.append((d_cls[rep], dc))

    # --------------------------------------------------------------- fixpoint
    def settle(self) -> int:
        """Apply pending merges, re-saturate, discharge congruent pairs.

        Returns the number of facts discharged this call.  Emissions go
        through ``prop.emit`` and thus back into the store listeners, so the
        engines' semi-naive marking picks the new facts up automatically."""
        eg = self.eg
        emitted = 0
        while self._pending or self.dirty:
            if self._pending:
                pend, self._pending = self._pending, []
                for a, b in pend:
                    if eg.find(a) != eg.find(b):
                        self.seeded += 1
                        eg.merge(a, b)
                # no re-saturation needed: every structural rewrite fires on
                # graph structure alone and lands as a hashconsed e-node over
                # class ids (canonical #chain / all_reduce / ppermute forms),
                # so rebuild's congruence closure propagates all downstream
                # consequences of the new merges
                eg.rebuild()
            if self.dirty:
                dirty, self.dirty = self.dirty, set()
                emitted += self._discharge({eg.find(r) for r in dirty})
        self.discharged += emitted
        return emitted

    def _discharge(self, roots) -> int:
        prop = self.prop
        seen_keys = prop.store._seen
        done = self._done_pairs
        out = 0
        for root in sorted(roots):
            ms = self.members.get(root)
            if not ms:
                continue
            base_ms = [m for m in ms if not m[0]]
            dist_ms = [m for m in ms if m[0]]
            if not base_ms or not dist_ms:
                continue
            for _, dnid, dop, dshape, ddtype, dlayer in dist_ms:
                if dop == "const":
                    # const_congruence deliberately pairs each dist const
                    # with ONE base const (they share a class; more pairings
                    # only widen the join search) — honor that here too
                    continue
                for _, bnid, bop, bshape, bdtype, blayer in base_ms:
                    if (bnid, dnid) in done:
                        continue
                    if bop == "const" or bshape != dshape or bdtype != ddtype:
                        continue
                    # same layer-pruning as _base_candidates; axis_index is
                    # exempt (its retired rule matched across layers)
                    if (dop != "axis_index" and dlayer is not None
                            and blayer is not None and blayer != dlayer):
                        continue
                    done.add((bnid, dnid))
                    f = Fact(DUP, bnid, dnid, prop.size,
                             Layout.identity(bshape))
                    k = f.key()
                    if k in self.fact_keys or k in seen_keys:
                        continue  # already discharged / already rule-derived
                    prop._fusion_recording = True
                    try:
                        prop.emit(f)
                    finally:
                        prop._fusion_recording = False
                    out += 1
        return out

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        return {
            "classes": self.eg.num_classes(),
            "merges": self.eg.version,
            "seeded": self.seeded,
            "discharged": self.discharged,
        }
