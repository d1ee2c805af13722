"""Relational facts between baseline and distributed tensors (paper §5.2.2).

Facts follow Figure 7's relational language.  Every fact relates one baseline
value ``B`` to one per-device distributed value ``D`` replicated/sharded over
``size`` devices along one mesh axis (the *verification axis*; multi-axis
meshes are verified one axis at a time, matching the paper's per-technique
verification).

Semantics (``L`` = ``fact.layout``, a :class:`~repro.core.bijection.Layout`):

=============  ==================================================================
kind           meaning
=============  ==================================================================
``dup``        ``D_r = L(B)`` for every rank r              (paper: duplicate/layout)
``shard``      ``stack_r(D_r) = L(B)`` with the stacked device axis as dst dim 0
               (paper: sharded, generalized with a layout)
``partial``    ``reduce_r(D_r, reduce_op) = L(B)``          (paper: partial)
``slicegrp``   ``D_r = chunk[r * n + index] of L(B)`` along dst dim ``dim`` split
               into ``size * n`` chunks                       (paper: slice)
``loopred``    ``D_r = reduce(op, { chunk[r*n+i] : i in idxset })`` — the running
               accumulation of an unrolled loop               (paper: loop_red_D)
=============  ==================================================================

The store also records **diagnostics**: near-miss rule firings (a join that
consumed a ``partial`` and a non-partial, an all-reduce over a ``dup``, a
layout mismatch with its synthesized repair bijection, a dtype mismatch).
These power bug localization (§5.3) and bug categorization (§7.3).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

from .bijection import Layout

DUP = "dup"
SHARD = "shard"
PARTIAL = "partial"
SLICEGRP = "slicegrp"
LOOPRED = "loopred"

# fact kinds interned to small ints: index keys pack (node_id, kind_id) into
# one int instead of hashing a (int, str) tuple on every store read/write
KINDS = (DUP, SHARD, PARTIAL, SLICEGRP, LOOPRED)
KIND_ID = {k: i for i, k in enumerate(KINDS)}

# exported constant name -> kind string ("DUP" -> "dup"): the vocabulary the
# registry static checker (repro.analysis.rulecheck) resolves when scanning
# rule-module sources for Fact constructions and kind reads
KIND_CONSTANTS = {"DUP": DUP, "SHARD": SHARD, "PARTIAL": PARTIAL,
                  "SLICEGRP": SLICEGRP, "LOOPRED": LOOPRED}
_KIND_BITS = 3  # 2**3 >= len(KINDS); key = (node_id << 3) | kind_id

# layouts interned to small ints for fact keys.  The interning key is
# (atoms, perm, dst_groups) — deliberately EXCLUDING src_groups — so two
# facts whose layouts differ only in source grouping keep deduplicating to
# one fact, exactly as the historical tuple-valued key did.  Ids are
# process-local (assigned in first-use order): fact keys must never be
# compared across processes — the process shard backend re-keys facts on
# the parent side after unpickling.
_LAYOUT_KEY_IDS: dict[tuple, int] = {}


def _layout_key_id(lay: Layout) -> int:
    kid = lay._kid
    if kid is None:
        t = (lay.atoms, lay.perm, lay.dst_groups)
        kid = _LAYOUT_KEY_IDS.get(t)
        if kid is None:
            kid = len(_LAYOUT_KEY_IDS)
            _LAYOUT_KEY_IDS[t] = kid
        object.__setattr__(lay, "_kid", kid)
    return kid


@dataclass(frozen=True, slots=True)
class Fact:
    kind: str
    base: int  # baseline node id
    dist: int  # distributed node id
    size: int  # device count c along the verification axis
    layout: Layout
    reduce_op: str = ""  # partial/loopred: add|max|min
    dim: int = -1  # slicegrp/loopred: chunked dst dim of L(B)
    nchunk: int = 0  # slicegrp/loopred: chunks per rank (n)
    index: int = -1  # slicegrp: local chunk index i
    idxset: frozenset = frozenset()  # loopred: accumulated local indices
    # dedup-key cache; process-local (holds an interned layout id), so it is
    # excluded from pickles via __reduce__ and recomputed on arrival
    _key: Optional[tuple] = field(default=None, init=False, compare=False,
                                  repr=False)

    def key(self) -> tuple:
        # hot path (every store lookup/add dedups on it): computed once
        k = self._key
        if k is None:
            k = (
                self.kind,
                self.base,
                self.dist,
                self.size,
                _layout_key_id(self.layout),
                self.reduce_op,
                self.dim,
                self.nchunk,
                self.index,
                self.idxset,
            )
            object.__setattr__(self, "_key", k)
        return k

    def __reduce__(self):
        return (Fact, (self.kind, self.base, self.dist, self.size,
                       self.layout, self.reduce_op, self.dim, self.nchunk,
                       self.index, self.idxset))

    def moved(self, base: int, dist: int) -> "Fact":
        """Copy with renamed endpoints (fast-path for memo replay; avoids
        ``dataclasses.replace``'s per-call field introspection)."""
        return Fact(self.kind, base, dist, self.size, self.layout,
                    self.reduce_op, self.dim, self.nchunk, self.index,
                    self.idxset)

    @property
    def clean(self) -> bool:
        """Identity layout — the fully aligned form (unit atoms ignored)."""
        lay = self.layout
        if self.kind == SHARD:
            # stacked layout: device atom (size c, + unit atoms) at dst dim 0,
            # remaining non-unit atoms in ascending order
            if not lay.dst_groups:
                return False
            g0 = lay.dst_groups[0]
            head = [p for p in lay.perm[:g0] if lay.atoms[p] != 1]
            if len(head) != 1 or lay.atoms[head[0]] != self.size:
                return False
            rest = [p for p in lay.perm[g0:] if lay.atoms[p] != 1]
            return rest == sorted(rest)
        nonunit = [p for p in lay.perm if lay.atoms[p] != 1]
        return nonunit == sorted(nonunit) and lay.dst_shape == lay.src_shape

    def short(self) -> str:
        extra = ""
        if self.kind == PARTIAL:
            extra = f",{self.reduce_op}"
        if self.kind in (SLICEGRP, LOOPRED):
            extra = f",dim={self.dim},n={self.nchunk},i={self.index},S={sorted(self.idxset)}"
        lay = "" if self.layout.is_identity else f",L={self.layout}"
        return f"{self.kind}(b%{self.base},d%{self.dist},c={self.size}{extra}{lay})"


@dataclass
class Diagnostic:
    """A near-miss explanation attached to a distributed node."""

    dist: int
    category: str  # e.g. missing_all_reduce / redundant_all_reduce /
    #                  wrong_replica_groups / precision_mismatch /
    #                  layout_mismatch / wrong_axis_split
    detail: str
    repair: Optional[list] = None  # synthesized bijection ops if applicable


class RelStore:
    def __init__(self) -> None:
        self.by_dist: dict[int, list[Fact]] = {}
        self.by_base: dict[int, list[Fact]] = {}
        # (dist, kind) and (base, kind) indexes: rule bodies that consume one
        # fact kind read these instead of linearly filtering the per-node
        # lists.  Keys are packed ints — (node_id << _KIND_BITS) | kind_id —
        # which hash/compare as machine ints instead of (int, str) tuples.
        self.by_dist_kind: dict[int, list[Fact]] = {}
        self.by_base_kind: dict[int, list[Fact]] = {}
        self._seen: set[tuple] = set()
        self.diagnostics: list[Diagnostic] = []
        self.num_derived = 0
        # notified with each batch of newly-added facts (a tuple/list); the
        # worklist engine hooks in here to enqueue the dist-graph consumers
        # of the changed nodes
        self.listeners: list = []
        # scopes/nodes verified wholesale by a trusted meta rule: their
        # internal nodes are exempt from frontier localization
        self.covered_scopes: set[str] = set()
        self.covered_nodes: set[int] = set()

    def _index(self, fact: Fact) -> None:
        kid = KIND_ID[fact.kind]
        self.by_dist.setdefault(fact.dist, []).append(fact)
        self.by_base.setdefault(fact.base, []).append(fact)
        self.by_dist_kind.setdefault((fact.dist << _KIND_BITS) | kid,
                                     []).append(fact)
        self.by_base_kind.setdefault((fact.base << _KIND_BITS) | kid,
                                     []).append(fact)
        self.num_derived += 1

    def add(self, fact: Fact) -> bool:
        k = fact.key()
        if k in self._seen:
            return False
        self._seen.add(k)
        self._index(fact)
        for listener in self.listeners:
            listener((fact,))
        return True

    def add_batch(self, facts: Iterable[Fact]) -> int:
        """Add many facts with a single (batched) listener notification —
        the merge path of sharded parallel rewriting."""
        added = []
        for fact in facts:
            k = fact.key()
            if k in self._seen:
                continue
            self._seen.add(k)
            self._index(fact)
            added.append(fact)
        if added:
            for listener in self.listeners:
                listener(added)
        return len(added)

    def facts(self, dist: int) -> list[Fact]:
        return self.by_dist.get(dist, [])

    def facts_kind(self, dist: int, kind: str) -> list[Fact]:
        return self.by_dist_kind.get((dist << _KIND_BITS) | KIND_ID[kind], [])

    def facts_for_base(self, base: int) -> list[Fact]:
        return self.by_base.get(base, [])

    def facts_for_base_kind(self, base: int, kind: str) -> list[Fact]:
        return self.by_base_kind.get((base << _KIND_BITS) | KIND_ID[kind], [])

    def verified(self, dist: int) -> bool:
        return bool(self.by_dist.get(dist))

    def diag(self, dist: int, category: str, detail: str, repair=None) -> None:
        self.diagnostics.append(Diagnostic(dist, category, detail, repair))

    def merge_from(self, other: "RelStore", base_map: dict[int, int], dist_map: dict[int, int]) -> None:
        """Import facts from a memoized layer verification, renaming node ids."""
        for facts in other.by_dist.values():
            for f in facts:
                if f.base in base_map and f.dist in dist_map:
                    self.add(f.moved(base_map[f.base], dist_map[f.dist]))
