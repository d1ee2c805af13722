"""A compact e-graph with hash-consing, union-find and congruence closure.

This is the equality-saturation substrate of the verifier (paper §2.2/§3).
It follows the classic egg design [Willsey et al., POPL'21]: e-nodes are
``(op, child e-class ids, params)`` tuples; e-classes are union-find
partitions; ``rebuild`` restores congruence after merges.

We deliberately keep the engine small: the heavy lifting in Scalify is the
*relational* layer (:mod:`repro.core.relations`) layered on top, exactly as
egglog layers Datalog over e-graphs.  The e-graph's job here is:

* canonicalize both IR graphs so structurally identical subtrees share an
  e-class (this powers baseline-node lookup during rule matching and layer
  memoization),
* saturate *structural* rewrites (layout-chain normalization, identity
  elimination, commutative canonicalization, collective algebra) so
  trivially-rewritten graphs merge without relational reasoning,
* carry a per-class (shape, dtype) *analysis* (egg's e-class analyses) that
  the relational tier and the fusion discharge query instead of re-deriving
  from member nodes.

The fusion tier proper — fact-seeded merges + congruent-class DUP discharge
interleaved with the rule engines — lives in
:mod:`repro.core.rules.fusion`, layered on the ``on_merge`` hook and the
shared-``EGraph`` multi-graph views below.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

from .bijection import Layout, NotSplitMerge
from .ir import COMMUTATIVE, Graph, Node


class ENode:
    """An e-node: ``(op, child e-class ids, params, shape, dtype)``.

    Hand-rolled (``__slots__`` + precomputed hash) rather than a dataclass:
    e-nodes are hashed on every hashcons probe and re-canonicalization, and
    the cached hash removes the dominant cost of congruence maintenance on
    large graphs."""

    __slots__ = ("op", "children", "params", "shape", "dtype", "_hash")

    def __init__(self, op: str, children: tuple[int, ...], params: tuple,
                 shape: tuple[int, ...], dtype: str) -> None:
        self.op = op
        self.children = children
        self.params = params
        self.shape = shape
        self.dtype = dtype
        self._hash = hash((op, children, params, shape, dtype))

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other: object) -> bool:
        if self is other:
            return True
        return (
            isinstance(other, ENode)
            and self._hash == other._hash
            and self.op == other.op
            and self.children == other.children
            and self.params == other.params
            and self.shape == other.shape
            and self.dtype == other.dtype
        )

    def __repr__(self) -> str:
        return (f"ENode({self.op!r}, {self.children!r}, {self.params!r}, "
                f"{self.shape!r}, {self.dtype!r})")

    def canon(self, find: Callable[[int], int]) -> "ENode":
        ch = tuple(map(find, self.children))
        if self.op in COMMUTATIVE and len(ch) == 2 and ch[0] > ch[1]:
            ch = (ch[1], ch[0])
        if ch == self.children:
            return self
        return ENode(self.op, ch, self.params, self.shape, self.dtype)


class EGraph:
    def __init__(self) -> None:
        self._parent: list[int] = []
        self._hashcons: dict[ENode, int] = {}
        # per-class member index, keyed by *root* class id.  Values are
        # insertion-ordered ``{enode: None}`` dicts (sets with stable order):
        # merge unions two dicts, repair moves/prunes individual entries, and
        # value-equal duplicates collapse — enodes()/num_classes() read this
        # directly instead of scanning the whole hashcons.
        self._class_nodes: dict[int, dict[ENode, None]] = {}
        # use-lists (egg's ``parents``): class id -> [(enode, owner class)]
        # for every e-node with a child in that class.  Repair after a merge
        # then touches only the e-nodes that *use* the absorbed class instead
        # of re-canonicalizing the entire hashcons.
        self._uses: dict[int, list[tuple[ENode, int]]] = {}
        self._worklist: list[int] = []
        self.version = 0  # bumped on every merge (saturation detection)
        # e-class analysis (egg §4): abstract (shape, dtype) per root class.
        # Joined on merge; a conflict joins to None (only unsound or
        # shape-polymorphic merges produce one — property-tested against).
        self.analysis: dict[int, Optional[tuple]] = {}
        # merge hook for overlays that index class membership externally
        # (the fusion tier): called as on_merge(kept_root, absorbed_root)
        # after every union, including those from congruence repair.
        self.on_merge: Optional[Callable[[int, int], None]] = None

    # -- union-find ---------------------------------------------------------
    def find(self, ec: int) -> int:
        root = ec
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[ec] != root:  # path compression
            self._parent[ec], ec = root, self._parent[ec]
        return root

    def _new_class(self) -> int:
        ec = len(self._parent)
        self._parent.append(ec)
        self._class_nodes[ec] = {}
        return ec

    # -- insertion ----------------------------------------------------------
    def add(self, enode: ENode) -> int:
        enode = enode.canon(self.find)
        found = self._hashcons.get(enode)
        if found is not None:
            return self.find(found)
        ec = self._new_class()
        self._hashcons[enode] = ec
        self._class_nodes[ec][enode] = None
        self.analysis[ec] = (enode.shape, enode.dtype)
        for child in set(enode.children):
            self._uses.setdefault(child, []).append((enode, ec))
        return ec

    def lookup(self, enode: ENode) -> Optional[int]:
        """Congruence lookup: the e-class of this e-node if present."""
        found = self._hashcons.get(enode.canon(self.find))
        return None if found is None else self.find(found)

    def clone(self) -> "EGraph":
        """Independent copy sharing the (immutable) e-nodes.  Container-level
        copies only, so cloning a saturated graph costs milliseconds where
        re-inserting and re-saturating costs hundreds — the fusion tier uses
        this to restart from a pristine saturated state per verification."""
        eg = EGraph.__new__(EGraph)
        eg._parent = list(self._parent)
        eg._hashcons = dict(self._hashcons)
        eg._class_nodes = {ec: dict(m) for ec, m in self._class_nodes.items()}
        eg._uses = {c: list(u) for c, u in self._uses.items()}
        eg._worklist = list(self._worklist)
        eg.version = self.version
        eg.analysis = dict(self.analysis)
        eg.on_merge = None  # hooks are per-owner, never shared
        return eg

    # -- merging + congruence closure ----------------------------------------
    def merge(self, a: int, b: int) -> int:
        a, b = self.find(a), self.find(b)
        if a == b:
            return a
        self.version += 1
        # union by use-list size: repair cost is proportional to the
        # absorbed side's uses, so absorb the lightly-used class
        if len(self._uses.get(a, ())) < len(self._uses.get(b, ())):
            a, b = b, a
        self._parent[b] = a
        absorbed = self._class_nodes.pop(b, None)
        if absorbed:
            self._class_nodes.setdefault(a, {}).update(absorbed)
        # analysis join: equal values survive, conflicts bottom out to None
        av, bv = self.analysis.get(a), self.analysis.pop(b, None)
        if av != bv:
            self.analysis[a] = None
        # the absorbed root's id is the use-list key to repair: every e-node
        # with a child in b is now non-canonical
        self._worklist.append(b)
        if self.on_merge is not None:
            self.on_merge(a, b)
        return a

    def rebuild(self) -> None:
        """Restore the congruence invariant after merges."""
        while self._worklist:
            todo, self._worklist = self._worklist, []
            for absorbed in todo:
                self._repair(absorbed)

    def _repair(self, absorbed: int) -> None:
        # Re-canonicalize only the e-nodes USING the absorbed class (egg's
        # repair): pop each stale hashcons entry, re-insert under the
        # canonical key, and merge congruent duplicates (which may enqueue
        # further repairs).
        for enode, ec in self._uses.pop(absorbed, ()):  # each absorbed id repairs once
            self._hashcons.pop(enode, None)
            canon = enode.canon(self.find)
            ec = self.find(ec)
            if canon is not enode:
                # reconcile the member index: the stale spelling is replaced
                # by its canonical form below
                members = self._class_nodes.get(ec)
                if members is not None:
                    members.pop(enode, None)
            other = self._hashcons.get(canon)
            if other is not None:
                other = self.find(other)
                if other != ec:
                    ec = self.merge(other, ec)
            self._hashcons[canon] = ec
            if canon is not enode:
                self._class_nodes.setdefault(ec, {})[canon] = None
                if other is None:
                    # value-new e-node: register its uses exactly once.  A
                    # canon value-equal to an existing hashcons entry already
                    # has use entries from its own insertion — re-appending
                    # (the old identity-check behavior) duplicated them on
                    # every rebuild of long-lived sessions.
                    for child in set(canon.children):
                        self._uses.setdefault(child, []).append((canon, ec))

    # -- queries --------------------------------------------------------------
    def enodes(self, ec: int) -> list[ENode]:
        """Member e-nodes of a class — O(class size) via the member index."""
        return list(self._class_nodes.get(self.find(ec), ()))

    def num_classes(self) -> int:
        # the member index is keyed by root ids only (absorbed keys are
        # popped on merge), so its size IS the class count
        return len(self._class_nodes)

    def analysis_of(self, ec: int) -> Optional[tuple]:
        """The (shape, dtype) abstract value of a class, or None on conflict."""
        return self.analysis.get(self.find(ec))


class GraphEGraph:
    """An e-graph view over one :class:`~repro.core.ir.Graph`.

    Maps every graph node id to an e-class; applies structural rewrites until
    saturation.  Leaf nodes (inputs/params) get *distinct* classes keyed by
    node id — two different parameters are never equal.  Content-addressed
    leaves (consts, and with ``content_leaves=True`` also iota/axis_index)
    share a class across every graph mounted on the same :class:`EGraph`:
    they are pure functions of their attributes, so equal attributes mean
    equal values at every rank.
    """

    STRUCTURAL_RULES = (
        "transpose_fuse",
        "transpose_identity",
        "reshape_fuse",
        "reshape_identity",
        "convert_identity",
        "broadcast_identity",
        "layout_chain_normalize",
        "all_reduce_canonicalize",
        "all_gather_reduce_scatter_elim",
        "ppermute_compose",
        "ppermute_identity",
        "orthogonal_collective_commute",
    )

    # rank-preserving collectives that commute across disjoint mesh axes
    # and disjoint touched dims (tuple-of-ranks semantics: concatenation /
    # summation along independent dims and independent axes commute)
    _COMMUTING = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")

    def __init__(self, graph: Graph, egraph: Optional[EGraph] = None,
                 tag: str = "", axis: Optional[str] = None,
                 axis_size: int = 0, content_leaves: bool = False) -> None:
        self.graph = graph
        self.eg = egraph or EGraph()
        self.tag = tag  # distinguishes leaves of different graphs sharing an EGraph
        self.axis = axis          # verified mesh axis (collective rewrites)
        self.axis_size = int(axis_size or 0)
        self.content_leaves = content_leaves
        self.node_class: dict[int, int] = {}
        self._leaf_enodes: dict[int, ENode] = {}
        # reshape/transpose chain memo: node id -> (chain root id, Layout)
        self._chain: dict[int, tuple[int, Layout]] = {}
        for node in graph:
            self.node_class[node.id] = self._insert(node)
        self._saturate_structural()

    # -- insertion -----------------------------------------------------------
    def _insert(self, node: Node) -> int:
        if not node.inputs:
            # leaf identity: consts with equal payloads are the same value
            # (merged eclass); content leaves are pure functions of their
            # attributes (params/shape/dtype live in the ENode, so equal
            # attributes hashcons to one class); other leaves stay unique
            # per node id
            if node.op == "const" and node.param("value_hash"):
                tag = f"const:{node.param('value_hash')}"
            elif self.content_leaves and node.op == "iota":
                tag = "iota"
            elif (self.content_leaves and node.op == "axis_index"
                  and self._other_axis(node)):
                # axis_index over a non-verified axis is the same value at
                # every rank of the verified axis; over the verified axis it
                # is rank-dependent and must stay per-node
                tag = "axis_index"
            else:
                tag = f"{self.tag}:{node.id}"
            enode = ENode(node.op, (), (("leaf", tag),) + node.params,
                          node.shape, node.dtype)
            self._leaf_enodes[node.id] = enode
            return self.eg.add(enode)
        children = tuple(self.eg.find(self.node_class[i]) for i in node.inputs)
        return self.eg.add(ENode(node.op, children, node.params, node.shape, node.dtype))

    def _other_axis(self, node: Node) -> bool:
        axes = node.param("axes") or ()
        return self.axis is not None and self.axis not in tuple(axes)

    def cls(self, nid: int) -> int:
        return self.eg.find(self.node_class[nid])

    def same(self, a: int, b: int) -> bool:
        return self.cls(a) == self.cls(b)

    # -- structural rewrites ---------------------------------------------------
    def _saturate_structural(self) -> None:
        """One-shot saturation: every rewrite that fires conditions only on
        *graph structure* (never on live class ids) and lands its conclusion
        as a hashconsed e-node whose children are class ids.  One pass in
        topological order therefore fires everything that can ever fire —
        a second sweep would re-deposit the same canonical e-nodes into the
        hashcons and match nothing new.  Later merges — cross-graph seeds,
        congruence cascades — are propagated entirely by ``rebuild``'s
        congruence closure; no re-saturation pass is ever needed (the fusion
        tier's ``settle`` counts on this)."""
        for node in self.graph:
            self._apply_structural(node)
        self.eg.rebuild()

    def _apply_structural(self, node: Node) -> None:
        g, eg = self.graph, self.eg
        if node.op == "transpose":
            perm = node.param("permutation")
            src = g[node.inputs[0]]
            if perm is not None and tuple(perm) == tuple(range(len(perm))):
                eg.merge(self.cls(node.id), self.cls(src.id))  # identity
            if src.op == "transpose" and perm is not None:
                p1 = src.param("permutation")
                if p1 is not None:
                    fused = tuple(p1[i] for i in perm)
                    merged = ENode(
                        "transpose",
                        (self.cls(src.inputs[0]),),
                        (("permutation", fused),),
                        node.shape,
                        node.dtype,
                    )
                    eg.merge(self.cls(node.id), eg.add(merged))
            self._normalize_chain(node)
        elif node.op == "reshape":
            src = g[node.inputs[0]]
            if node.shape == src.shape:
                eg.merge(self.cls(node.id), self.cls(src.id))  # identity
            if src.op == "reshape":
                merged = ENode(
                    "reshape",
                    (self.cls(src.inputs[0]),),
                    (("new_sizes", node.shape),),
                    node.shape,
                    node.dtype,
                )
                eg.merge(self.cls(node.id), eg.add(merged))
                if node.shape == g[src.inputs[0]].shape:
                    eg.merge(self.cls(node.id), self.cls(src.inputs[0]))
            self._normalize_chain(node)
        elif node.op == "convert":
            src = g[node.inputs[0]]
            if node.dtype == src.dtype:
                eg.merge(self.cls(node.id), self.cls(src.id))
        elif node.op == "broadcast":
            src = g[node.inputs[0]]
            if node.shape == src.shape and node.param("broadcast_dimensions") == tuple(
                range(len(src.shape))
            ):
                eg.merge(self.cls(node.id), self.cls(src.id))
        elif node.op == "all_reduce":
            self._canon_all_reduce(node)
            self._commute_collectives(node)
        elif node.op == "all_gather":
            self._elim_gather_scatter(node)
            self._commute_collectives(node)
        elif node.op in ("reduce_scatter", "all_to_all"):
            self._commute_collectives(node)
        elif node.op == "ppermute":
            self._compose_ppermute(node)

    # -- layout-chain normalization --------------------------------------------
    def _normalize_chain(self, node: Node) -> None:
        """Compose a whole reshape/transpose chain into one :class:`Layout`
        bijection from the chain's source.  Effectively-identity chains merge
        with the source (catches multi-op round-trips the pairwise fuse rules
        miss, e.g. split-then-merge reshapes interleaved with transposes);
        chains with equal composed bijections merge through a canonical
        ``#chain`` e-node over the source class — hashconsing unites them
        now if the sources already coincide, and congruence closure unites
        them later if the sources merge afterwards."""
        g, eg = self.graph, self.eg
        cached = self._chain.get(node.id)
        if cached is None:
            src = g[node.inputs[0]]
            base = self._chain.get(src.id)
            root, lay = base if base is not None else (src.id,
                                                       Layout.identity(src.shape))
            try:
                if node.op == "reshape":
                    lay = lay.then_reshape(node.shape)
                else:
                    perm = node.param("permutation")
                    if perm is None:
                        return
                    lay = lay.then_transpose(perm)
            except (NotSplitMerge, ValueError):
                return  # non-split/merge chain: node starts a fresh chain
            cached = self._chain[node.id] = (root, lay)
        root, lay = cached
        if lay.effectively_identity and node.shape == g[root].shape:
            eg.merge(self.cls(node.id), self.cls(root))
            return
        canon = ENode("#chain", (self.cls(root),),
                      (("#chain", lay.atoms, lay.src_groups, lay.perm,
                        lay.dst_groups),),
                      node.shape, node.dtype)
        eg.merge(self.cls(node.id), eg.add(canon))

    # -- collective algebra ----------------------------------------------------
    @staticmethod
    def _full_group(node: Node) -> bool:
        groups = node.param("groups")
        return groups is None or groups == "full"

    @staticmethod
    def _touched_dims(node: Node) -> tuple:
        if node.op == "all_gather":
            return (node.param("all_gather_dimension", 0),)
        if node.op == "reduce_scatter":
            return (node.param("scatter_dimension", 0),)
        if node.op == "all_to_all":
            return (node.param("split_axis"), node.param("concat_axis"))
        return ()

    def _ar_enode(self, input_cls: int, axes, reduce_op: str,
                  shape, dtype) -> ENode:
        """Canonical all_reduce form: one synthetic spelling shared by real
        all_reduce nodes and all_gather∘reduce_scatter chains, so psum and
        psum_scatter+all_gather implementations land in one e-class once
        their inputs merge."""
        return ENode("all_reduce", (input_cls,),
                     (("#canon", ("axes", tuple(axes)), ("op", reduce_op)),),
                     shape, dtype)

    def _canon_all_reduce(self, node: Node) -> None:
        if not self._full_group(node):
            return
        canon = self._ar_enode(self.cls(node.inputs[0]),
                               node.param("axes") or (),
                               node.param("reduce_op", "add"),
                               node.shape, node.dtype)
        self.eg.merge(self.cls(node.id), self.eg.add(canon))

    def _elim_gather_scatter(self, node: Node) -> None:
        """``all_gather(reduce_scatter(y))`` along the same dim/axes with
        full groups and unchanged shape is ``all_reduce(y)``: the scatter
        leaves each rank a reduced slab, the gather reassembles all slabs —
        every rank ends with the full reduction."""
        g = self.graph
        src = g[node.inputs[0]]
        if src.op != "reduce_scatter":
            return
        if not (self._full_group(node) and self._full_group(src)):
            return
        y = g[src.inputs[0]]
        if (node.param("all_gather_dimension", 0) == src.param("scatter_dimension", 0)
                and (node.param("axes") or ()) == (src.param("axes") or ())
                and node.shape == y.shape
                and node.dtype == y.dtype):
            canon = self._ar_enode(self.cls(y.id), node.param("axes") or (),
                                   src.param("reduce_op", "add"),
                                   node.shape, node.dtype)
            self.eg.merge(self.cls(node.id), self.eg.add(canon))

    def _compose_ppermute(self, node: Node) -> None:
        """ppermute∘ppermute over one axis composes by relational join of
        the (src, dst) pair lists (ranks outside a perm receive zero, and
        the join propagates zeros exactly); a composed identity covering the
        whole verified axis is the input itself."""
        g, eg = self.graph, self.eg
        if not self._full_group(node):
            return
        axes = node.param("axes") or ()
        perm = tuple(node.param("perm") or ())
        src = g[node.inputs[0]]
        canon_params = (("#canon", ("axes", tuple(axes)),
                        ("perm", tuple(sorted(perm)))),)
        eg.merge(self.cls(node.id),
                 eg.add(ENode("ppermute", (self.cls(src.id),), canon_params,
                              node.shape, node.dtype)))
        if self._identity_perm(axes, perm):
            eg.merge(self.cls(node.id), self.cls(src.id))
        if (src.op == "ppermute" and (src.param("axes") or ()) == axes
                and self._full_group(src)):
            inner = {s: t for s, t in (src.param("perm") or ())}
            fused = tuple(sorted((s, t2) for s, m in inner.items()
                                 for m2, t2 in perm if m == m2))
            canon = ENode("ppermute", (self.cls(src.inputs[0]),),
                          (("#canon", ("axes", tuple(axes)), ("perm", fused)),),
                          node.shape, node.dtype)
            eg.merge(self.cls(node.id), eg.add(canon))
            if self._identity_perm(axes, fused):
                eg.merge(self.cls(node.id), self.cls(src.inputs[0]))

    def _identity_perm(self, axes, perm) -> bool:
        # total identity needs full rank coverage — only decidable on the
        # verified axis, whose size is known
        return (self.axis_size > 0 and tuple(axes) == (self.axis,)
                and len(perm) == self.axis_size
                and all(s == t for s, t in perm)
                and len({s for s, _ in perm}) == self.axis_size)

    def _commute_collectives(self, node: Node) -> None:
        """Orthogonal-collective transparency: two rank-preserving full-group
        collectives over *disjoint* mesh axes and *disjoint* touched dims
        commute (concatenation/summation along independent dims of
        independent rank tuples).  A non-``add`` reduction only commutes
        past pure data movement (gather/all-to-all)."""
        g, eg = self.graph, self.eg
        src = g[node.inputs[0]]
        if src.op not in self._COMMUTING or node.op not in self._COMMUTING:
            return
        if not (self._full_group(node) and self._full_group(src)):
            return
        n_axes = tuple(node.param("axes") or ())
        s_axes = tuple(src.param("axes") or ())
        if not n_axes or not s_axes or set(n_axes) & set(s_axes):
            return
        x = g[src.inputs[0]]
        # rank-preserving only: an untiled gather inserts a dim and shifts
        # every downstream dim index
        if not (len(node.shape) == len(src.shape) == len(x.shape)):
            return
        n_touched, s_touched = set(self._touched_dims(node)), set(self._touched_dims(src))
        if n_touched & s_touched:
            return
        n_op = node.param("reduce_op", "add")
        s_op = src.param("reduce_op", "add")
        if n_op != "add" and src.op not in ("all_gather", "all_to_all"):
            return
        if s_op != "add" and node.op not in ("all_gather", "all_to_all"):
            return
        # swapped spelling: node's collective applied first (on x), then
        # src's.  Shapes: node's touched dims take their post-node extents,
        # everything else keeps x's.
        inner_shape = tuple(
            node.shape[i] if i in n_touched else x.shape[i]
            for i in range(len(x.shape))
        )
        inner = ENode(node.op, (self.cls(x.id),), node.params, inner_shape,
                      node.dtype)
        outer = ENode(src.op, (eg.add(inner),), src.params, node.shape,
                      node.dtype)
        eg.merge(self.cls(node.id), eg.add(outer))

    # -- congruence lookup used by the relational rules -------------------------
    def find_node(self, op: str, child_classes: Iterable[int], params: tuple,
                  shape: tuple[int, ...], dtype: str) -> Optional[int]:
        """E-class of ``op(child_classes)`` if such a node exists, else None."""
        return self.eg.lookup(
            ENode(op, tuple(self.eg.find(c) for c in child_classes), params, shape, dtype)
        )

    def class_info(self, nid: int) -> Optional[tuple]:
        """(shape, dtype) e-class analysis for a node's class (None on
        analysis conflict — never for purely structural saturation)."""
        return self.eg.analysis_of(self.node_class[nid])
