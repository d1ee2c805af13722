"""The Propagator: shared matching context + the pass-based reference engine.

The Propagator holds everything a rule needs to fire — the baseline and
distributed graphs, the fact store, the baseline e-graph for congruence
matching — and exposes the emission/matching helpers the rule functions in
the family modules use (`emit`, `_base_candidates`, `_shard_src_dim`, ...).

Two evaluation strategies drive the rules:

* :meth:`run` — the original pass-based loop: rescan every node each pass
  until no new fact is derived (kept as the parity reference engine);
* :class:`~repro.core.rules.engine.WorklistEngine` — semi-naive worklist
  evaluation: a node is (re)visited only when one of its inputs gained a
  fact.  :meth:`run_worklist` is the convenience entry point.

Soundness: every rule is a theorem about SPMD semantics (several are
property-tested against a numpy SPMD simulator in
``tests/test_rules_simulator.py``).  When no rule fires, no fact is derived —
the node stays unverified; the verifier never claims equivalence it cannot
justify.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Iterable, Optional, Sequence

from ..bijection import Layout, NotSplitMerge, infer_bijection
from ..egraph import GraphEGraph
from ..ir import COMMUTATIVE, Graph, Node
from ..relations import DUP, SHARD, Fact, RelStore
from .common import shard_stack_layout
from .registry import RuleRegistry


class Propagator:
    def __init__(
        self,
        base: Graph,
        dist: Graph,
        size: int,
        store: Optional[RelStore] = None,
        base_eg: Optional[GraphEGraph] = None,
        axis: str = "model",
        registry: Optional[RuleRegistry] = None,
        fusion: bool = False,
    ) -> None:
        from .registry import DEFAULT_REGISTRY

        self.base = base
        self.dist = dist
        self.size = size
        self.axis = axis
        self.store = store or RelStore()
        if registry is None:
            # fusion-on runs use the trimmed default registry (the e-graph
            # tier discharges what the retired rules derived); fusion-off
            # runs get the retired rules back so coverage never regresses
            if fusion:
                registry = DEFAULT_REGISTRY
            else:
                from .legacy import legacy_registry

                registry = legacy_registry()
        self.registry = registry
        # keys of facts emitted by the fusion discharge (and its closure
        # cascade): the layer memoizer must not template them (fusion.py)
        self.fusion_keys: set = set()
        self._fusion_recording = False
        if fusion:
            from .fusion import FusionTier

            self.fusion: Optional[FusionTier] = FusionTier(self)
        else:
            self.fusion = None
        # congruence-matching view: fusion runs reuse the tier's base view —
        # its merge set is a strict superset of the standalone view's (it
        # adds content-addressed leaves and fact-seeded equalities, all
        # sound per-rank equalities), so matching only gains power, and one
        # whole GraphEGraph build per verification disappears
        self.base_eg = base_eg or (
            self.fusion.base_view if self.fusion is not None
            else GraphEGraph(base, tag="base"))
        self.rule_invocations = 0
        # RuleProfiler under VerifyOptions(profile=True); None keeps the
        # dispatch hot path clock-free
        self.profiler = None
        self._loopred_base_cache: dict[tuple, Optional[int]] = {}
        self._ec_consumers: Optional[dict[int, list[int]]] = None
        self._engine = None
        # (op-signature, layout) -> composed layout for the baseline layout
        # closure in emit(): repeated layers recompute identical compositions
        self._closure_cache: dict[tuple, Optional[Layout]] = {}

    # ------------------------------------------------------------------ api
    def register_input(self, fact: Fact) -> None:
        self.emit(fact)

    def register_dup(self, b: int, d: int) -> None:
        self.emit(Fact(DUP, b, d, self.size, Layout.identity(self.base[b].shape)))

    def register_shard(self, b: int, d: int, dim: int) -> None:
        lay = shard_stack_layout(self.base[b].shape, dim, self.size)
        self.emit(Fact(SHARD, b, d, self.size, lay))

    def dispatch(self, node: Node, kinds: Optional[frozenset] = None) -> None:
        """Fire the registered rules for ``node``.  With ``kinds`` given,
        fire only rules consuming one of those fact kinds (semi-naive
        re-visit after the node's inputs gained facts of those kinds)."""
        if self.profiler is not None:
            return self._dispatch_profiled(node, kinds)
        for rule in self.registry.rules_for(node.op):
            if kinds is not None and rule.consumes and not (rule.consumes & kinds):
                continue
            self.rule_invocations += 1
            rule.fn(self, node)

    def _dispatch_profiled(self, node: Node,
                           kinds: Optional[frozenset] = None) -> None:
        from time import perf_counter

        prof = self.profiler
        for rule in self.registry.rules_for(node.op):
            if kinds is not None and rule.consumes and not (rule.consumes & kinds):
                continue
            self.rule_invocations += 1
            t0 = perf_counter()
            rule.fn(self, node)
            prof.record(rule.name, node.op, perf_counter() - t0)

    def run(self, nodes: Optional[Iterable[int]] = None, max_passes: int = 30) -> None:
        """Pass-based evaluation to fixpoint (reference engine)."""
        todo = sorted(nodes) if nodes is not None else list(range(len(self.dist.nodes)))
        for _ in range(max_passes):
            before = self.store.num_derived
            for nid in todo:
                self.dispatch(self.dist[nid])
            self.apply_meta_rules()
            if self.fusion is not None:
                self.fusion.settle()
            if self.store.num_derived == before:
                break

    def run_worklist(self, nodes: Optional[Iterable[int]] = None) -> None:
        """Semi-naive worklist evaluation to fixpoint."""
        self.worklist_engine().run(nodes)

    # ------------------------------------------------------ parallel shards
    def prewarm_shared(self) -> None:
        """Materialize lazily-built shared structures (consumer indexes, the
        e-class consumer map) before parallel sharding — shards then only
        read them."""
        if len(self.base.nodes):
            self._class_consumers(0)
        self.base.consumer_index()
        self.dist.consumer_index()

    def shard_clone(self, store) -> "Propagator":
        """Shallow copy evaluating against a shard-local overlay store.
        Graphs, e-graph and caches are shared read-only; the invocation
        counter restarts so the parent can merge it after the barrier."""
        import copy

        p = copy.copy(self)
        p.store = store
        p.rule_invocations = 0
        p._engine = None
        # shards never settle: the fusion tier (listener + e-graph) stays
        # bound to the parent store; discharge happens after the merge
        # barrier when add_batch replays the shard facts to the listeners
        p.fusion = None
        p._fusion_recording = False
        if self.profiler is not None:
            from ..report import RuleProfiler

            p.profiler = RuleProfiler()  # merged after the stage barrier
        return p

    def worklist_engine(self):
        if self._engine is None:
            from .engine import WorklistEngine

            self._engine = WorklistEngine(self)
        return self._engine

    def apply_meta_rules(self) -> None:
        from . import meta

        meta.apply_meta_rules(self)

    # legacy spelling used by older callers
    def _apply_meta_rules(self, todo=None) -> None:
        del todo
        self.apply_meta_rules()

    # ------------------------------------------------------------- emission
    def emit(self, fact: Fact, _depth: int = 0) -> None:
        if fact.kind == DUP and fact.layout.effectively_identity:
            # canonicalize effectively-identity same-shape DUP layouts to the
            # interned identity: a reshape-split round trip composes to e.g.
            # atoms (2,2)/dst_groups (2,) — the same bijection as identity
            # (4,) but a different dedup key.  Normalizing keeps rule-derived
            # and fusion-discharged spellings of one fact key-equal.
            bshape = self.base[fact.base].shape
            if bshape == self.dist[fact.dist].shape:
                ident = Layout.identity(bshape)
                if fact.layout is not ident:
                    # manual rebuild: dataclasses.replace costs ~7us and this
                    # runs for every spelled-out identity DUP on the hot path
                    fact = Fact(fact.kind, fact.base, fact.dist, fact.size,
                                ident, fact.reduce_op, fact.dim, fact.nchunk,
                                fact.index, fact.idxset)
        added = self.store.add(fact)
        if added and self._fusion_recording:
            self.fusion_keys.add(fact.key())
        if not added or _depth > 8:
            return
        # baseline layout closure: fact(b, d) and z = layout_op(b)  =>  fact(z, d)
        for zid in self.base.consumers(fact.base):
            z = self.base[zid]
            if (z.op == "broadcast" and fact.kind == DUP
                    and fact.layout.effectively_identity):
                # baseline-only broadcast of a replicated value: if it scales
                # exactly one degenerate dim by c, the (identical) per-device
                # values stack into it -> shard fact; equal shapes -> dup.
                dshape = self.dist[fact.dist].shape
                if len(z.shape) == len(dshape):
                    diff = [k for k in range(len(dshape)) if z.shape[k] != dshape[k]]
                    if not diff:
                        self.emit(Fact(DUP, zid, fact.dist, self.size,
                                       Layout.identity(z.shape)), _depth + 1)
                    elif (len(diff) == 1 and dshape[diff[0]] == 1
                          and z.shape[diff[0]] == self.size):
                        try:
                            lay = shard_stack_layout(z.shape, diff[0], self.size)
                        except NotSplitMerge:
                            continue
                        self.emit(Fact(SHARD, zid, fact.dist, self.size, lay),
                                  _depth + 1)
                continue
            if z.op not in ("reshape", "transpose"):
                continue
            src_shape = self.base[fact.base].shape
            arg = z.shape if z.op == "reshape" else z.param("permutation")
            ck = (z.op, src_shape, arg, fact.layout)
            new_lay = self._closure_cache.get(ck, False)
            if new_lay is False:
                try:
                    op_lay = Layout.identity(src_shape)
                    if z.op == "reshape":
                        op_lay = op_lay.then_reshape(z.shape)
                    else:
                        op_lay = op_lay.then_transpose(arg)
                    new_lay = op_lay.inverse().compose(fact.layout)
                except (NotSplitMerge, ValueError):
                    new_lay = None
                self._closure_cache[ck] = new_lay
            if new_lay is None:
                continue
            self.emit(replace(fact, base=zid, layout=new_lay), _depth + 1)

    # --------------------------------------------------------- base matching
    def _class_consumers(self, b: int) -> list[int]:
        """Consumers of every baseline node congruent to ``b`` (e.g. all
        copies of the same constant share an eclass)."""
        if self._ec_consumers is None:
            eg = self.base_eg
            by_cls: dict[int, list[int]] = {}
            for n in self.base:
                for i in n.inputs:
                    by_cls.setdefault(eg.cls(i), []).append(n.id)
            # keyed by nid, not class root: under fusion the shared e-graph
            # keeps merging after this snapshot, so roots move — a nid key
            # stays valid while still sharing one list per build-time class
            self._ec_consumers = {
                n.id: by_cls.get(eg.cls(n.id), []) for n in self.base}
        return self._ec_consumers.get(b, [])

    def _base_candidates(
        self, op: str, b_inputs: Sequence[int], params: Optional[tuple] = None,
        layer=None,
    ) -> list[Node]:
        """Baseline nodes ``z = op(b_inputs...)`` (inputs matched up to
        e-graph congruence; commutative ops also match swapped).  ``layer``
        restricts candidates to the same layer tag — a pure optimization:
        baseline/distributed layer numbering is aligned by construction, and
        merged-constant eclasses otherwise make this scan O(layers)."""
        out = []
        for zid in self._class_consumers(b_inputs[0]):
            z = self.base[zid]
            if z.op != op or len(z.inputs) != len(b_inputs):
                continue
            if layer is not None and z.layer is not None and z.layer != layer:
                continue
            if params is not None and z.params != params:
                continue
            ok = all(self.base_eg.same(zi, bi) for zi, bi in zip(z.inputs, b_inputs))
            if not ok and op in COMMUTATIVE and len(b_inputs) == 2:
                ok = self.base_eg.same(z.inputs[0], b_inputs[1]) and self.base_eg.same(
                    z.inputs[1], b_inputs[0]
                )
            if ok:
                out.append(z)
        return out

    def _dtype_ok(self, z: Node, d: Node) -> bool:
        if z.dtype != d.dtype:
            self.store.diag(
                d.id,
                "precision_mismatch",
                f"baseline {z.short()} is {z.dtype} but distributed {d.short()} is {d.dtype}",
            )
            return False
        return True

    def _shard_src_dim(self, f: Fact) -> Optional[int]:
        """For a clean shard fact, the baseline dim carrying the device atom
        (device atom must be the *outer* factor of that dim).  Unit atoms are
        ignored throughout — they carry no data."""
        lay = f.layout
        if not lay.dst_groups:
            return None
        g0 = lay.dst_groups[0]
        head = [p for p in lay.perm[:g0] if lay.atoms[p] != 1]
        if len(head) != 1 or lay.atoms[head[0]] != self.size:
            return None
        dev_atom = head[0]
        # remaining atoms must be in ascending order (identity layout otherwise)
        rest = [p for p in lay.perm[g0:] if lay.atoms[p] != 1]
        if rest != sorted(rest):
            return None
        acc = 0
        for dim, g in enumerate(lay.src_groups):
            if acc <= dev_atom < acc + g:
                # outer factor check: all atoms of this dim before dev_atom are 1
                if any(lay.atoms[k] != 1 for k in range(acc, dev_atom)):
                    return None
                return dim
            acc += g
        return None

    def _layouts_joinable(self, f1: Fact, f2: Fact) -> bool:
        try:
            return f1.layout.equivalent(f2.layout)
        except ValueError:
            return False

    # ----------------------------------------------------------- diagnostics
    def _diag_layout(self, d: Node, combo: Sequence[Fact]) -> None:
        if not combo:
            return
        f0 = combo[0]
        f1 = combo[1] if len(combo) > 1 else f0
        repair = None
        try:
            repair = infer_bijection(f0.layout, f1.layout)
        except Exception:
            repair = None
        if not repair:
            for f in (f1, f0):
                repair = self.suggest_repair(f)
                if repair:
                    break
        self.store.diag(
            d.id,
            "layout_mismatch",
            f"{d.op} at {d.src or '?'} consumes operands with mismatched layouts "
            f"{f0.layout} vs {f1.layout}",
            repair=repair,
        )

    def suggest_repair(self, f: Fact) -> Optional[list]:
        """Synthesize the reshape/transpose sequence mapping a *misaligned*
        distributed tensor onto its clean placement (Algorithm 2 step 4, the
        paper's BSH-repair output).  Returns per-device ops, or None."""
        if f.clean:
            return None
        bshape = self.base[f.base].shape
        if f.kind == DUP:
            delta = None
            try:
                delta = f.layout.inverse()
            except Exception:
                return None
            return delta.synthesize_ops() or None
        if f.kind != SHARD:
            return None
        for k in range(len(bshape)):
            if bshape[k] % self.size != 0:
                continue
            try:
                clean = shard_stack_layout(bshape, k, self.size)
                delta = f.layout.inverse().compose(clean)
            except (NotSplitMerge, ValueError):
                continue
            # the device dim must stay put (repair acts on local dims only)
            if delta.perm and delta.perm[0] == 0 and delta.dst_groups and delta.dst_groups[0] == 1:
                ops = delta.synthesize_ops()
                if not ops:
                    continue
                # strip the stacked device dim into per-device ops
                local_ops = []
                for op, arg in ops:
                    if op == "reshape":
                        if arg[0] != self.size:
                            break
                        local_ops.append(("reshape", tuple(arg[1:])))
                    else:
                        if arg[0] != 0:
                            break
                        local_ops.append(("transpose", tuple(a - 1 for a in arg[1:])))
                else:
                    if local_ops:
                        return local_ops
        return None
