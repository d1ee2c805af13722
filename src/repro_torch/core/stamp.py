"""Layer stamping: O(block_period) tracing for unrolled deep models.

``verify_model_tp`` unrolls every layer in Python so the Scalify partitioner
sees per-layer named scopes — but that makes *jax tracing* linear in depth,
which dominates end-to-end verification time long before rule evaluation
does (paper §5.1 keeps the per-layer *verification* cost near-constant via
partitioning + memoization; tracing was never on their critical path because
the framework hands them the IR).

Stamping restores the O(block_period) bound: trace only ``TRACE_PERIODS``
(= 3) repetitions of the model's repeating block, prove the trace is
*periodic* by structurally diffing the 2nd repetition against the 3rd, then
clone ("stamp") the remaining repetitions directly in TensorIR — re-indexing
node ids, layer tags, scope strings and parameter slice offsets — and
re-wire the postamble.  The first traced period is never used as the
template: its boundary (embedding output, first-use constants) may differ
from the steady state, so we validate period 1 against period 2 and stamp
from period 2.

Any irregularity — non-contiguous period regions, unequal lengths, a node
pair whose op/shape/params/src differ beyond a slice-offset delta, a
postamble reference that cannot be classified — aborts the stamp
(``stamp_graph`` returns ``None``) and the caller falls back to tracing the
full model.  Stamping therefore never changes a verdict: the stamped graph
is node-by-node identical to the full trace (``tests/test_stamping.py``).

The returned graph carries a :class:`StampInfo` that
:class:`~repro.core.partition.PartitionedVerifier` uses to serve layer
fingerprints and boundary-input lists for stamped periods as O(1) lookups
against the template period instead of re-hashing every layer.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Optional

from .ir import Graph, Node

# periods traced before stamping kicks in: template + validation + the
# (possibly boundary-irregular) first period
TRACE_PERIODS = 3

_LAYER_NUM_RE = re.compile(r"((?:^|/)layer_?)(\d+)")

# slice params allowed to differ between corresponding nodes of two periods
# (stacked-parameter block indexing advances by a constant per period)
_DELTA_PARAMS = ("start_indices", "limit_indices")


@dataclass
class StampInfo:
    """Periodicity metadata attached to a stamped :class:`Graph`."""

    period_len: int  # L: nodes per period region
    static_cut: int  # last node id of period 0 (ids <= cut are period-invariant)
    traced_periods: int  # periods present in the underlying trace
    total_periods: int  # periods in the stamped graph
    tag_delta: int  # layer-tag advance per period
    template_min_tag: int  # smallest layer tag inside the template period

    @property
    def template_period(self) -> int:
        return self.traced_periods - 1

    def period_of_tag(self, tag: int) -> int:
        return self.template_period + (tag - self.template_min_tag) // self.tag_delta

    def template_tag(self, tag: int) -> int:
        """Layer tag of the template-period layer corresponding to ``tag``."""
        p = self.period_of_tag(tag)
        return tag - (p - self.template_period) * self.tag_delta

    def node_shift(self, period: int) -> int:
        """Id offset of ``period``'s region relative to the template region."""
        return (period - self.template_period) * self.period_len

    def shift_node(self, nid: int, period: int) -> int:
        """Map a template-period node id into ``period`` (static ids fixed)."""
        return nid if nid <= self.static_cut else nid + self.node_shift(period)


def _scope_shift(scope: str, delta: int) -> str:
    """Advance the layer index embedded in a named-scope path by ``delta``."""
    if not scope or delta == 0:
        return scope
    return _LAYER_NUM_RE.sub(lambda m: f"{m.group(1)}{int(m.group(2)) + delta}", scope)


def _scope_layer_num(scope: str) -> Optional[int]:
    m = _LAYER_NUM_RE.search(scope)
    return None if m is None else int(m.group(2))


def _param_delta(n1: Node, n2: Node) -> Optional[dict]:
    """``None`` if params are incompatible; ``{}`` if equal; otherwise the
    per-period integer deltas of slice start/limit indices."""
    if n1.params == n2.params:
        return {}
    if n1.op != "slice":
        return None
    d1, d2 = dict(n1.params), dict(n2.params)
    if set(d1) != set(d2):
        return None
    deltas: dict = {}
    for k in d1:
        if d1[k] == d2[k]:
            continue
        if k not in _DELTA_PARAMS or not isinstance(d1[k], tuple):
            return None
        if len(d1[k]) != len(d2[k]):
            return None
        deltas[k] = tuple(b - a for a, b in zip(d1[k], d2[k]))
    # start and limit must advance in lockstep (a pure block-index advance)
    if deltas.get("start_indices") != deltas.get("limit_indices"):
        return None
    return deltas


def _shift_params(node: Node, deltas: dict, steps: int) -> Optional[tuple]:
    if not deltas:
        return None  # caller reuses the frozen params tuple
    out = dict(node.params)
    for k, dv in deltas.items():
        out[k] = tuple(v + d * steps for v, d in zip(out[k], dv))
    return tuple(sorted(out.items()))


class _Periodicity:
    """The validated diff between the last two traced periods."""

    def __init__(self, g: Graph, static_cut: int, period_len: int,
                 tag_delta: int, scope_delta: int,
                 param_deltas: dict[int, dict]):
        self.g = g
        self.static_cut = static_cut
        self.period_len = period_len
        self.tag_delta = tag_delta
        self.scope_delta = scope_delta
        # template node id -> slice param deltas (only nodes that advance)
        self.param_deltas = param_deltas


def _period_cuts(g: Graph, period_of_tag: Callable[[int], int]) -> Optional[list[int]]:
    """``cuts[p]`` = max node id tagged in period ``p``; None if tags miss a
    period or a tagged node sits outside its period's id range."""
    cuts: dict[int, int] = {}
    for n in g:
        if n.layer is None:
            continue
        p = period_of_tag(n.layer)
        cuts[p] = max(cuts.get(p, -1), n.id)
    if not cuts or sorted(cuts) != list(range(len(cuts))):
        return None
    out = [cuts[p] for p in range(len(cuts))]
    if out != sorted(out):
        return None  # period regions interleave: not stampable
    bounds, prev = [], -1
    for hi in out:
        bounds.append((prev, hi))
        prev = hi
    for n in g:
        if n.layer is None:
            continue
        lo, hi = bounds[period_of_tag(n.layer)]
        if not (lo < n.id <= hi):
            return None
    return out


def _validate(g: Graph, cuts: list[int]) -> Optional[_Periodicity]:
    """Diff the last two traced periods; None if the trace is not periodic."""
    cut_a, cut_b, cut_t = cuts[-3], cuts[-2], cuts[-1]
    L = cut_b - cut_a
    if L <= 0 or cut_t - cut_b != L:
        return None
    tag_delta: Optional[int] = None
    scope_delta: Optional[int] = None
    param_deltas: dict[int, dict] = {}
    for q in range(L):
        n1, n2 = g[cut_a + 1 + q], g[cut_b + 1 + q]
        if (n1.op != n2.op or n1.shape != n2.shape or n1.dtype != n2.dtype
                or n1.src != n2.src or len(n1.inputs) != len(n2.inputs)):
            return None
        # layer tags advance uniformly
        if (n1.layer is None) != (n2.layer is None):
            return None
        if n1.layer is not None:
            d = n2.layer - n1.layer
            if tag_delta is None:
                tag_delta = d
            elif d != tag_delta:
                return None
        # scopes equal modulo a uniform layer-number advance
        if n1.scope != n2.scope:
            s1, s2 = _scope_layer_num(n1.scope), _scope_layer_num(n2.scope)
            if s1 is None or s2 is None:
                return None
            d = s2 - s1
            if scope_delta is None:
                scope_delta = d
            elif d != scope_delta:
                return None
            if _scope_shift(n1.scope, d) != n2.scope:
                return None
        # inputs: static (identical, before the periodic span) or advancing
        # by exactly one period length
        for i1, i2 in zip(n1.inputs, n2.inputs):
            if i2 == i1 and i2 <= cut_a:
                continue
            if i2 == i1 + L and i2 > cut_a:
                continue
            return None
        deltas = _param_delta(n1, n2)
        if deltas is None:
            return None
        if deltas:
            param_deltas[n2.id] = deltas
    if tag_delta is None or tag_delta <= 0:
        return None
    return _Periodicity(g, cut_a, L, tag_delta, scope_delta or 0, param_deltas)


def _stacked_leaf_fixups(g: Graph, per: _Periodicity) -> Optional[dict[int, tuple[int, int]]]:
    """Leaves sliced with a per-period offset advance must grow their stacked
    dimension from ``traced`` to ``total`` periods.

    Returns ``{leaf_id: (dim, per_period_delta)}`` or None when a grown leaf
    is consumed in a way the fixup cannot preserve.
    """
    out: dict[int, tuple[int, int]] = {}
    for nid, deltas in per.param_deltas.items():
        node = per.g[nid]
        start_delta = deltas.get("start_indices")
        if start_delta is None:
            continue
        dims = [d for d, v in enumerate(start_delta) if v != 0]
        if len(dims) != 1 or start_delta[dims[0]] <= 0:
            return None
        leaf = node.inputs[0] if node.inputs else None
        if leaf is None or leaf > per.static_cut:
            continue  # slices an in-period tensor: no leaf to grow
        dim, dv = dims[0], start_delta[dims[0]]
        prev = out.get(leaf)
        if prev is not None and prev != (dim, dv):
            return None
        out[leaf] = (dim, dv)
    # Growing a leaf's stacked dim is only transparent to slice consumers
    # (their own start/limit stay in bounds and their result shapes are
    # unchanged); any other consumer would see a stale operand shape.
    for leaf in out:
        for c in g.consumers(leaf):
            if g[c].op != "slice":
                return None
    return out


def _postamble_families(g: Graph, per: _Periodicity,
                        cut_t: int) -> Optional[dict[int, tuple[list[int], int]]]:
    """Per-period replica families in the postamble, discovered from their
    consuming ``concat``.

    ``jnp.stack(outs)`` over per-period cache outputs traces as one
    expand-dims node per period feeding a single concat.  A *family* is a
    length-``nt`` input segment of a postamble concat whose members are
    structurally identical single-input postamble nodes referencing
    consecutive periods (the period-0 member may sit anywhere in period 0's
    irregular region; the later members must be exactly one period length
    apart).  Stamping clones the template member once per stamped period.

    Returns ``{last_member_id: (member_ids, template_ref)}``; None only on
    an internally inconsistent graph (never expected).
    """
    nt, L, cut_a = TRACE_PERIODS, per.period_len, per.static_cut
    fams: dict[int, tuple[list[int], int]] = {}
    for nid in range(cut_t + 1, len(g.nodes)):
        n = g[nid]
        if n.op != "concat":
            continue
        raw = list(n.inputs)
        for j in range(len(raw) - nt + 1):
            seg = raw[j: j + nt]
            if not all(cut_t < s < nid for s in seg):
                continue
            ms = [g[s] for s in seg]
            t = ms[-1]
            if any(len(m.inputs) != 1 for m in ms):
                continue
            if any((m.op, m.shape, m.dtype, m.params, m.src, m.scope)
                   != (t.op, t.shape, t.dtype, t.params, t.src, t.scope)
                   for m in ms):
                continue
            refs = [m.inputs[0] for m in ms]
            tref = refs[-1]
            if not (cut_t - L < tref <= cut_t):
                continue  # template member must reference the template period
            ok = all(refs[k] == tref - (nt - 1 - k) * L for k in range(1, nt))
            if not ok or refs[0] > cut_a:
                continue
            fams[seg[-1]] = (seg, tref)
    return fams


def stamp_graph(
    g: Graph,
    total_periods: int,
    period_of_tag: Callable[[int], int],
) -> Optional[Graph]:
    """Extend a ``TRACE_PERIODS``-period trace to ``total_periods`` periods.

    Returns the stamped graph (with ``.stamp`` set to a :class:`StampInfo`),
    or ``None`` when the trace is not period-regular — the caller must then
    fall back to tracing the full model.
    """
    cuts = _period_cuts(g, period_of_tag)
    if cuts is None or len(cuts) != TRACE_PERIODS or total_periods <= len(cuts):
        return None
    per = _validate(g, cuts)
    if per is None:
        return None
    leaf_fix = _stacked_leaf_fixups(g, per)
    if leaf_fix is None:
        return None
    # shard_map re-issues stacked leaves with per-shard shapes; the dead
    # outer originals must grow their stacked dim too (same slice-only
    # consumer requirement — growing a leaf with a live non-slice consumer
    # would desync it from the full trace)
    inv_alias = {v: k for k, v in (getattr(g, "input_alias", None) or {}).items()}
    for leaf, (dim, dv) in list(leaf_fix.items()):
        outer = inv_alias.get(leaf)
        if outer is not None and outer != leaf:
            if g[outer].shape[dim] != g[leaf].shape[dim]:
                return None
            if any(g[c].op != "slice" for c in g.consumers(outer)):
                return None
            leaf_fix[outer] = (dim, dv)

    nt, K, L = TRACE_PERIODS, total_periods, per.period_len
    cut_a, cut_t = per.static_cut, cuts[-1]
    tpl_lo = cuts[-2] + 1
    extra = K - nt
    final_shift = extra * L
    fams = _postamble_families(g, per, cut_t)
    if fams is None:
        return None
    member_ids = {m for members, _ in fams.values() for m in members}

    ng = Graph(g.name)
    nodes = ng.nodes
    # -- static prefix + the three traced periods (leaf shapes grown) --------
    for n in g.nodes[: cut_t + 1]:
        if n.id in leaf_fix:
            dim, dv = leaf_fix[n.id]
            shape = list(n.shape)
            shape[dim] += dv * extra
            n = Node(n.id, n.op, n.inputs, tuple(shape), n.dtype, n.params,
                     n.src, n.layer, n.scope)
        nodes.append(n)
    # -- stamped periods ------------------------------------------------------
    scope_cache: dict[tuple[str, int], str] = {}
    for p in range(nt, K):
        steps = p - (nt - 1)
        shift = steps * L
        for q in range(L):
            t = g[tpl_lo + q]
            params = _shift_params(t, per.param_deltas.get(t.id, {}), steps)
            scope = t.scope
            if scope and per.scope_delta:
                ck = (scope, steps)
                scope = scope_cache.get(ck)
                if scope is None:
                    scope = _scope_shift(t.scope, per.scope_delta * steps)
                    scope_cache[ck] = scope
            nodes.append(Node(
                id=len(nodes),
                op=t.op,
                inputs=tuple(i if i <= cut_a else i + shift for i in t.inputs),
                shape=t.shape,
                dtype=t.dtype,
                params=t.params if params is None else params,
                src=t.src,
                layer=None if t.layer is None else t.layer + steps * per.tag_delta,
                scope=scope,
            ))

    # -- postamble ------------------------------------------------------------
    remap: dict[int, int] = {}
    fam_clones: dict[int, list[int]] = {}  # template ref -> stamped clone ids

    def remap_ref(i: int) -> Optional[int]:
        """New id for a pre-postamble reference from the postamble."""
        if i <= cut_a:
            return i  # static (or period 0, whose identity is preserved)
        if i <= cut_t - L:
            return None  # period 1: ambiguous — would not advance with depth
        if i <= cut_t:
            return i + final_shift  # template period -> final period
        return None

    for nid in range(cut_t + 1, len(g.nodes)):
        n = g[nid]
        shape = n.shape
        if nid in member_ids:
            new_inputs = n.inputs  # traced family members keep their refs
        elif n.op == "concat":
            # extend any input segment that is a complete family (or a direct
            # per-period run ending in the template period) with the stamped
            # periods' replicas
            new_list: list[int] = []
            tpl_extents: list[int] = []  # template node id per extended segment
            raw = list(n.inputs)
            j = 0
            while j < len(raw):
                seg = raw[j: j + nt]
                fam = fams.get(seg[-1]) if len(seg) == nt else None
                if fam is not None and seg == fam[0]:
                    new_list.extend(remap[m] for m in seg)
                    new_list.extend(fam_clones[fam[1]])
                    tpl_extents.append(seg[-1])
                    j += nt
                    continue
                if (len(seg) == nt and all(s <= cut_t for s in seg)
                        and cut_t - L < seg[-1] <= cut_t
                        and seg == [seg[-1] - (nt - 1 - k) * L for k in range(nt)]):
                    new_list.extend(seg)
                    new_list.extend(seg[-1] + (p - (nt - 1)) * L
                                    for p in range(nt, K))
                    tpl_extents.append(seg[-1])
                    j += nt
                    continue
                ri = remap.get(raw[j]) if raw[j] > cut_t else remap_ref(raw[j])
                if ri is None:
                    return None
                new_list.append(ri)
                j += 1
            if len(new_list) != len(n.inputs):
                dim = n.param("dimension")
                if dim is None:
                    return None
                shape = list(n.shape)
                # each extended segment grows the dim by its own template
                # member's extent (segments may differ; unrelated inputs
                # contribute nothing)
                shape[dim] += extra * sum(
                    int(g[t].shape[dim]) for t in tpl_extents)
                shape = tuple(shape)
            new_inputs = tuple(new_list)
        else:
            new_list = []
            for i in n.inputs:
                ri = remap.get(i) if i > cut_t else remap_ref(i)
                if ri is None:
                    return None
                new_list.append(ri)
            new_inputs = tuple(new_list)

        new_id = len(nodes)
        remap[nid] = new_id
        nodes.append(Node(new_id, n.op, new_inputs, tuple(shape), n.dtype,
                          n.params, n.src, n.layer, n.scope))
        if nid in fams:
            # right after the last traced member: emit the stamped clones in
            # period order (matching the full trace's node layout)
            members, canon = fams[nid]
            clones = []
            for p in range(nt, K):
                cid = len(nodes)
                nodes.append(Node(cid, n.op, (canon + (p - (nt - 1)) * L,),
                                  n.shape, n.dtype, n.params, n.src, n.layer,
                                  n.scope))
                clones.append(cid)
            fam_clones[canon] = clones

    ng.outputs = []
    for o in g.outputs:
        ro = remap.get(o) if o > cut_t else remap_ref(o)
        if ro is None:
            return None
        ng.outputs.append(ro)

    tpl_tags = [n.layer for n in g.nodes[tpl_lo: cut_t + 1] if n.layer is not None]
    ng.stamp = StampInfo(
        period_len=L,
        static_cut=cut_a,
        traced_periods=nt,
        total_periods=K,
        tag_delta=per.tag_delta,
        template_min_tag=min(tpl_tags),
    )
    return ng
