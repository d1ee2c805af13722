"""TensorIR: the graph representation Scalify-JAX verifies.

A :class:`Graph` is a flat, append-only SSA dataflow graph extracted from a
jaxpr (see :mod:`repro.core.trace`) or constructed directly (benchmarks / bug
injection).  Nodes carry op name, static params, shape/dtype, a source
location (``file.py:line``) for bug localization, and an optional ``layer``
tag used by the partitioner (Algorithm 1 in the paper).

Op vocabulary (the verifier's rules are polymorphic over most of it):

* leaf:        ``input``, ``param``, ``const``, ``iota``
* elementwise: ``add sub mul div max min pow neg exp log tanh logistic rsqrt
               sqrt erf abs sign floor select compare and or not integer_pow``
* layout:      ``reshape`` (params: new_sizes), ``transpose`` (params:
               permutation), ``broadcast`` (params: shape, broadcast_dims),
               ``convert`` (params: new_dtype), ``squeeze``/``expand_dims``
               are canonicalized to ``reshape``
* structure:   ``slice`` (params: start, limit, strides), ``concat``
               (params: dimension), ``pad``, ``gather``, ``scatter``,
               ``dynamic_slice``, ``dynamic_update_slice``, ``rev``
* compute:     ``dot`` (params: dimension_numbers), ``conv``,
               ``reduce_sum/max/min/prod/and/or`` (params: axes),
               ``argmax``, ``cumsum``, ``sort``, ``top_k``
* collective:  ``all_reduce`` (params: reduce_op, axis, axis_size, groups),
               ``all_gather`` (params: dim/tiled, axis, axis_size),
               ``reduce_scatter`` (params: dim, axis, axis_size),
               ``all_to_all`` (params: split_axis, concat_axis, axis,
               axis_size), ``ppermute`` (params: perm, axis), ``axis_index``
* opaque:      anything else — sound: never verified unless both sides have a
               congruent opaque node.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace
from typing import Any, Iterable, Iterator, Optional, Sequence

# ---------------------------------------------------------------------------
# op classes

ELEMENTWISE = frozenset(
    "add sub mul div max min pow neg exp log log1p tanh logistic rsqrt sqrt erf "
    "abs sign floor ceil round select compare and or xor not integer_pow sin cos "
    "square cbrt exp2 is_finite rem clamp nextafter lt le gt ge eq ne".split()
)
LAYOUT_OPS = frozenset({"reshape", "transpose"})
COLLECTIVES = frozenset(
    {"all_reduce", "all_gather", "reduce_scatter", "all_to_all", "ppermute"}
)
REDUCES = frozenset(
    {"reduce_sum", "reduce_max", "reduce_min", "reduce_prod", "reduce_and", "reduce_or"}
)
LEAF_OPS = frozenset({"input", "param", "const", "iota"})

# Commutative binary ops — children are canonically ordered in the e-graph.
COMMUTATIVE = frozenset({"add", "mul", "max", "min", "and", "or", "xor"})


def _freeze(value: Any) -> Any:
    """Recursively convert params to hashable canonical form.

    NaN floats (gather/pad fill values) are rewritten to one shared object:
    ``nan != nan`` defeats tuple equality except through the per-element
    identity shortcut, and ``hash(nan)`` is id-based on modern CPython —
    only a canonical singleton keeps structurally identical nodes equal
    (and equally hashed) across traces and across pickle round-trips (see
    ``_CANON_NAN`` below)."""
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, set):
        return tuple(sorted(_freeze(v) for v in value))
    if isinstance(value, float) and value != value:
        return _CANON_NAN
    return value


@dataclass(frozen=True)
class Node:
    """A single SSA value in the graph."""

    id: int
    op: str
    inputs: tuple[int, ...]
    shape: tuple[int, ...]
    dtype: str
    params: tuple = ()  # frozen key/value tuple (see Graph.add)
    src: str = ""  # "file.py:line" best effort
    layer: Optional[int] = None  # layer tag for partitioning
    scope: str = ""  # named_scope path, e.g. "block/attn/flash_decode"

    def param(self, key: str, default: Any = None) -> Any:
        for k, v in self.params:
            if k == key:
                return v
        return default

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n

    def short(self) -> str:
        ins = ",".join(f"%{i}" for i in self.inputs)
        return f"%{self.id} = {self.op}({ins}) {self.dtype}{list(self.shape)}"


# the single NaN object unpickled graphs share.  Rule matching compares
# base vs dist params with tuple equality, which only treats NaN as equal
# through its per-element identity shortcut; pickle does not memoize floats,
# so every unpickled NaN (gather fill_value etc.) would be a distinct object
# and structurally identical nodes would stop matching.  Rewriting every NaN
# to this one object on load restores the in-process invariant.
_CANON_NAN = float("nan")


def _canon_nan_value(v):
    if isinstance(v, float) and v != v:
        return _CANON_NAN
    if isinstance(v, tuple):
        if not any(isinstance(x, (float, tuple)) for x in v):
            return v  # fast path: nothing a NaN could hide in
        fixed = tuple(_canon_nan_value(x) for x in v)
        return v if all(a is b for a, b in zip(v, fixed)) else fixed
    return v


def _canon_nan_params(nodes: list) -> None:
    for i, n in enumerate(nodes):
        fixed = _canon_nan_value(n.params)
        if fixed is not n.params:
            nodes[i] = replace(n, params=fixed)


class Graph:
    """Append-only SSA tensor dataflow graph."""

    def __init__(self, name: str = "graph") -> None:
        self.name = name
        self.nodes: list[Node] = []
        self.outputs: list[int] = []
        self._consumers: Optional[dict[int, list[int]]] = None
        # periodicity metadata when this graph was produced by layer stamping
        # (see repro.core.stamp); None for ordinary traces
        self.stamp = None

    # -- construction ------------------------------------------------------
    def add(
        self,
        op: str,
        inputs: Sequence[int] = (),
        shape: Sequence[int] = (),
        dtype: str = "float32",
        params: Optional[dict] = None,
        src: str = "",
        layer: Optional[int] = None,
        scope: str = "",
    ) -> int:
        nid = len(self.nodes)
        frozen = tuple(sorted((k, _freeze(v)) for k, v in (params or {}).items()))
        self.nodes.append(
            Node(
                id=nid,
                op=op,
                inputs=tuple(int(i) for i in inputs),
                shape=tuple(int(s) for s in shape),
                dtype=str(dtype),
                params=frozen,
                src=src,
                layer=layer,
                scope=scope,
            )
        )
        self._consumers = None
        return nid

    def mark_output(self, *nids: int) -> None:
        self.outputs.extend(int(n) for n in nids)

    # -- access ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    def __getitem__(self, nid: int) -> Node:
        return self.nodes[nid]

    def __iter__(self) -> Iterator[Node]:
        return iter(self.nodes)

    # -- serialization -----------------------------------------------------
    # the consumer index is a derived cache: drop it from pickles (the disk
    # store and the process shard backend both ship graphs) and rebuild on
    # first use after load
    def __getstate__(self) -> dict:
        return {"name": self.name, "nodes": self.nodes,
                "outputs": self.outputs, "stamp": self.stamp}

    def __setstate__(self, state: dict) -> None:
        self.name = state["name"]
        self.nodes = state["nodes"]
        self.outputs = state["outputs"]
        self.stamp = state.get("stamp")
        self._consumers = None
        _canon_nan_params(self.nodes)

    def stable_digest(self) -> str:
        """Process-independent content hash of the full graph.

        Unlike :meth:`fingerprint` (Python ``hash()``, randomized per
        process by PYTHONHASHSEED), this sha256 digest is stable across
        processes and runs — the persistent verification store uses it to
        validate that a deserialized graph is byte-equivalent to the one
        that was saved."""
        h = hashlib.sha256()
        h.update(repr(self.outputs).encode())
        for n in self.nodes:
            h.update(repr((n.op, n.inputs, n.shape, n.dtype, n.params,
                           n.src, n.layer, n.scope)).encode())
        return h.hexdigest()

    def consumer_index(self) -> dict[int, list[int]]:
        """Precomputed consumer adjacency (node id -> consumer node ids).

        Built once per graph mutation epoch; the worklist engine walks it on
        every derived fact, so callers may hold the returned dict directly
        while the graph is static."""
        if self._consumers is None:
            cons: dict[int, list[int]] = {}
            for n in self.nodes:
                for i in n.inputs:
                    cons.setdefault(i, []).append(n.id)
            self._consumers = cons
        return self._consumers

    def consumers(self, nid: int) -> list[int]:
        return self.consumer_index().get(nid, [])

    def dead_ids(self) -> set[int]:
        """Node ids with no consumers that are not graph outputs.

        Tracing legitimately leaves some (jax keeps unused jaxpr invars,
        and surgery can strand a replaced node); the static analysis tier
        walks this set to flag the subset that still costs something at
        runtime — e.g. a dead collective's communication."""
        cons = self.consumer_index()
        outs = set(self.outputs)
        return {n.id for n in self.nodes
                if n.id not in outs and not cons.get(n.id)}

    def toposort(self, roots: Optional[Iterable[int]] = None) -> list[int]:
        """Node ids in topological order (ids are already topological since
        the graph is append-only SSA, but subsets need filtering)."""
        if roots is None:
            return list(range(len(self.nodes)))
        keep: set[int] = set()
        stack = list(roots)
        while stack:
            nid = stack.pop()
            if nid in keep:
                continue
            keep.add(nid)
            stack.extend(self.nodes[nid].inputs)
        return sorted(keep)

    def layers(self) -> dict[Optional[int], list[int]]:
        """Group node ids by layer tag (None = untagged pre/postamble)."""
        out: dict[Optional[int], list[int]] = {}
        for n in self.nodes:
            out.setdefault(n.layer, []).append(n.id)
        return out

    # -- structural fingerprint (layer memoization) -------------------------
    def fingerprint(self, nids: Sequence[int], normalize_slices: bool = False) -> int:
        """Order-insensitive-to-absolute-id structural hash of a subgraph.

        Node ids are renumbered by position within ``nids``; external inputs
        are numbered by first use.  Shapes/dtypes/params/ops all contribute,
        source locations and layer tags do not (two structurally identical
        layers hash equal — the memoization key of §5.1).

        ``normalize_slices=True`` abstracts the *offsets* of slices taken from
        external tensors (keeping extents): layer i slicing ``W[i]`` then
        hashes equal to layer j slicing ``W[j]``.  Callers must separately pin
        the base<->dist offset alignment (see PartitionedVerifier).
        """
        local = {nid: i for i, nid in enumerate(nids)}
        ext: dict[int, int] = {}
        sig = []
        for nid in nids:
            n = self.nodes[nid]
            ins = []
            external_slice = False
            for i in n.inputs:
                if i in local:
                    ins.append(("l", local[i]))
                else:
                    if i not in ext:
                        ext[i] = len(ext)
                    src = self.nodes[i]
                    ins.append(("e", ext[i], src.shape, src.dtype))
                    external_slice = True
            params = n.params
            if normalize_slices and n.op == "slice" and external_slice:
                st = n.param("start_indices")
                li = n.param("limit_indices")
                if st is not None and li is not None:
                    extents = tuple(lim - s for s, lim in zip(st, li))
                    params = (("extents", extents), ("strides", n.param("strides")))
            sig.append((n.op, tuple(ins), n.shape, n.dtype, params))
        return hash(tuple(sig))

    def slice_offsets(self, nids: Sequence[int]) -> list[tuple]:
        """Start offsets of external-input slices within a subgraph, in node
        order (used to pin memoization alignment across graph pairs)."""
        inside = set(nids)
        out = []
        for nid in sorted(nids):
            n = self.nodes[nid]
            if n.op == "slice" and n.inputs and n.inputs[0] not in inside:
                out.append(tuple(n.param("start_indices") or ()))
        return out

    def pretty(self, max_nodes: int = 80) -> str:
        lines = [f"graph {self.name} ({len(self.nodes)} nodes)"]
        for n in self.nodes[:max_nodes]:
            lines.append("  " + n.short())
        if len(self.nodes) > max_nodes:
            lines.append(f"  ... {len(self.nodes) - max_nodes} more")
        lines.append(f"  outputs: {self.outputs}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# bounded structural diff (delta re-verification)


@dataclass(frozen=True)
class GraphDelta:
    """Alignment between an old graph and an edited new graph.

    Old node ids below ``prefix`` map to themselves, ids at or above
    ``old_end`` map shifted by ``shift`` (insertion/deletion renumbers the
    tail), and ids inside ``[prefix, old_end)`` — a deleted block — map to
    nothing.  ``changed`` lists new-graph ids that have no content-identical
    counterpart in the old graph: inserted nodes plus any surviving node
    whose fields or (mapped) inputs differ — e.g. consumers rewired onto the
    edit.  Delta re-verification must rework those from scratch; everything
    else keeps its cached layer templates."""

    changed: tuple[int, ...]
    prefix: int
    old_end: int
    shift: int

    def map_old(self, nid: int) -> Optional[int]:
        if nid < self.prefix:
            return nid
        if nid >= self.old_end:
            return nid + self.shift
        return None


def _same_node(a: Node, b: Node, inputs: tuple) -> bool:
    """Field equality modulo absolute id, with ``a``'s inputs pre-mapped."""
    return (a.op == b.op and inputs == b.inputs and a.shape == b.shape
            and a.dtype == b.dtype and a.params == b.params
            and a.src == b.src and a.layer == b.layer and a.scope == b.scope)


def diff_graphs(old: Graph, new: Graph,
                max_changed: int = 96) -> Optional[GraphDelta]:
    """Align ``new`` against ``old`` when they differ in a bounded node set.

    Handles the two edit shapes bug injection / single-op edits produce:
    in-place field edits (same length — possibly several scattered sites)
    and one contiguous block inserted or deleted at the first divergence
    point (ids after it shift).  Surgery that rewires consumer inputs onto
    the edit — every injector that splices a node in or drops one does —
    marks those consumers changed too, so ``changed`` is closed over every
    node whose content differs.  Returns ``None`` when no alignment with at
    most ``max_changed`` changed nodes exists — callers must then fall back
    to a full re-verification (sound: a failed diff never produces a wrong
    verdict, only a slower run)."""
    no, nn = len(old.nodes), len(new.nodes)
    shift = nn - no
    if abs(shift) > max_changed:
        return None
    if shift == 0:
        changed = tuple(n.id for n, m in zip(old.nodes, new.nodes) if n != m)
        if len(changed) > max_changed:
            return None
        return GraphDelta(changed, no, no, 0)
    # One block inserted (shift > 0) or deleted (shift < 0) at the first
    # divergence point p; every surviving old node j then sits at j + shift.
    # Validate that interpretation node-by-node: a survivor whose fields or
    # mapped inputs disagree is marked changed rather than failing the
    # alignment (the id correspondence still holds — only its content was
    # rewritten, e.g. an input rewired onto the spliced block).
    p = 0
    lim = min(no, nn)
    while p < lim and old.nodes[p] == new.nodes[p]:
        p += 1
    old_end = p if shift > 0 else p - shift
    if old_end > no:
        return None
    changed = set(range(p, p + max(shift, 0)))  # inserted block, new ids

    def mapped(q: int) -> Optional[int]:
        if q < p:
            return q
        if q >= old_end:
            return q + shift
        return None

    for j in range(old_end, no):
        a, b = old.nodes[j], new.nodes[j + shift]
        ins = tuple(mapped(q) for q in a.inputs)
        if None in ins or not _same_node(a, b, ins):
            changed.add(j + shift)
            if len(changed) > max_changed:
                return None
    return GraphDelta(tuple(sorted(changed)), p, old_end, shift)
