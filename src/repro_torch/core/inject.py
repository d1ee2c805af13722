"""Silent-error injection: graph surgery reproducing the paper's five bug
categories (§7.3) for the detection benchmark (Tables 4/5 analogue).

Each injector takes a distributed TensorIR graph and returns a mutated copy
plus metadata (description, expected diagnostic category, injected site).
The mutations mirror real-world bugs: missing/redundant all-reduce, wrong
replica groups, swapped reshape dims (the BSH bug of Fig. 1), wrong transpose,
precision drop, wrong all-gather dim, wrong all-to-all axes, shifted slices.

Injectors are registered in :data:`DEFAULT_INJECTORS` (an
:class:`InjectorRegistry` mirroring the rule and scenario registries) with
their bug category, mutated-op applicability predicate, and a one-line
description — the detection-benchmark campaign
(:mod:`repro.verify.campaign`) sweeps the registry across scenarios, and
``python -m repro.verify --list-injectors`` enumerates it.  Calling the
module-level functions directly still works but is deprecated in favor of
``DEFAULT_INJECTORS.get(name)`` (see docs/TESTING.md).

Injectors are **pure**: they never modify the input graph — the mutation is
graph surgery into a fresh :class:`Graph` (the contract
``Session.verify(mutate_pure=True)`` relies on to reuse cached pairs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .ir import Graph, Node


@dataclass
class Injection:
    name: str
    description: str
    category: str  # expected diagnostic category (paper bug classes 1-5)
    graph: Graph
    site: str  # source location of the mutated node


class InjectorError(ValueError):
    """Unknown injector name (CLI maps this to exit code 2)."""


@dataclass(frozen=True)
class InjectorSpec:
    """One registered injector: a pure graph mutation plus its metadata."""

    name: str
    category: str  # expected diagnostic category of the injected bug
    site_op: str  # op the mutation rewrites (fast applicability filter)
    fn: Callable  # fn(graph, index=0) -> Optional[Injection]
    doc: str = ""

    def applicable(self, g: Graph) -> bool:
        """Cheap necessary condition; ``fn`` may still return None when its
        site predicate (e.g. both dims > 1) rejects every candidate."""
        return any(n.op == self.site_op for n in g)

    def __call__(self, g: Graph, index: int = 0) -> Optional[Injection]:
        return self.fn(g, index=index)


class InjectorRegistry:
    """Named injectors with category/site metadata (mirrors the rule and
    scenario registries: one decorated registration per injector)."""

    def __init__(self) -> None:
        self._by_name: dict[str, InjectorSpec] = {}

    # -- registration (decorator) ------------------------------------------
    def injector(self, name: str, *, category: str, site_op: str,
                 doc: str = ""):
        def deco(fn: Callable) -> Callable:
            if name in self._by_name:
                raise ValueError(f"injector {name!r} registered twice")
            self._by_name[name] = InjectorSpec(name, category, site_op, fn, doc)
            return fn

        return deco

    # -- lookup ------------------------------------------------------------
    def get(self, name: str) -> InjectorSpec:
        spec = self._by_name.get(name)
        if spec is None:
            raise InjectorError(
                f"unknown injector {name!r} "
                f"(registered: {', '.join(self.names())})")
        return spec

    def names(self) -> list[str]:
        return sorted(self._by_name)

    def specs(self) -> list[InjectorSpec]:
        return [self._by_name[n] for n in self.names()]

    def applicable_to(self, g: Graph) -> list[InjectorSpec]:
        return [s for s in self.specs() if s.applicable(g)]

    def describe(self) -> str:
        lines = []
        for s in self.specs():
            lines.append(f"{s.name:22s} category={s.category:20s} "
                         f"site={s.site_op:14s} {s.doc}")
        return "\n".join(lines)


# The default registry, populated by the @DEFAULT_INJECTORS.injector
# decorations below.
DEFAULT_INJECTORS = InjectorRegistry()


def _remap_params(params: tuple, **updates) -> dict:
    d = {k: v for k, v in params}
    d.update(updates)
    return d


def _surgery(g: Graph, edit: Callable[[Graph, Node, dict[int, int]], Optional[int]]) -> Graph:
    """Rebuild the graph applying ``edit`` to each node.  ``edit`` returns the
    new node id (or None to re-add the node unchanged)."""
    ng = Graph(g.name + "+bug")
    remap: dict[int, int] = {}
    for n in g:
        new_id = edit(ng, n, remap)
        if new_id is None:
            new_id = ng.add(
                n.op,
                [remap[i] for i in n.inputs],
                n.shape,
                n.dtype,
                {k: v for k, v in n.params},
                src=n.src,
                layer=n.layer,
                scope=n.scope,
            )
        remap[n.id] = new_id
    ng.outputs = [remap[o] for o in g.outputs]
    return ng


def _find(g: Graph, op: str, pred=None, index: int = 0) -> Optional[Node]:
    hits = [n for n in g if n.op == op and (pred is None or pred(n))]
    return hits[index] if len(hits) > index else None


# ---------------------------------------------------------------------------
# category 1: incorrect distributed operation


@DEFAULT_INJECTORS.injector(
    "drop_all_reduce", category="missing_all_reduce", site_op="all_reduce",
    doc="bypass an all_reduce entirely (partial sum leaks downstream)")
def drop_all_reduce(g: Graph, index: int = 0) -> Optional[Injection]:
    tgt = _find(g, "all_reduce", index=index)
    if tgt is None:
        return None

    def edit(ng: Graph, n: Node, remap):
        if n.id == tgt.id:
            return remap[n.inputs[0]]  # bypass the collective entirely
        return None

    return Injection(
        f"drop_all_reduce@{index}",
        f"removed all_reduce at {tgt.src}",
        "missing_all_reduce",
        _surgery(g, edit),
        tgt.src,
    )


@DEFAULT_INJECTORS.injector(
    "duplicate_all_reduce", category="redundant_all_reduce",
    site_op="all_reduce",
    doc="apply an all_reduce twice (replicated tensor scaled by axis size)")
def duplicate_all_reduce(g: Graph, index: int = 0) -> Optional[Injection]:
    tgt = _find(g, "all_reduce", index=index)
    if tgt is None:
        return None

    def edit(ng: Graph, n: Node, remap):
        if n.id == tgt.id:
            first = ng.add(n.op, [remap[i] for i in n.inputs], n.shape, n.dtype,
                           {k: v for k, v in n.params}, src=n.src, layer=n.layer, scope=n.scope)
            return ng.add(n.op, [first], n.shape, n.dtype,
                          {k: v for k, v in n.params}, src=n.src, layer=n.layer, scope=n.scope)
        return None

    return Injection(
        f"duplicate_all_reduce@{index}",
        f"duplicated all_reduce at {tgt.src}",
        "redundant_all_reduce",
        _surgery(g, edit),
        tgt.src,
    )


@DEFAULT_INJECTORS.injector(
    "wrong_collective_op", category="unverified_frontier",
    site_op="all_reduce",
    doc="all_reduce(add) silently becomes all_reduce(max)")
def wrong_collective_op(g: Graph, index: int = 0) -> Optional[Injection]:
    tgt = _find(g, "all_reduce", lambda n: n.param("reduce_op") == "add", index)
    if tgt is None:
        return None

    def edit(ng: Graph, n: Node, remap):
        if n.id == tgt.id:
            return ng.add(n.op, [remap[i] for i in n.inputs], n.shape, n.dtype,
                          _remap_params(n.params, reduce_op="max"),
                          src=n.src, layer=n.layer, scope=n.scope)
        return None

    return Injection(
        f"wrong_collective_op@{index}",
        f"all_reduce(add) replaced by all_reduce(max) at {tgt.src}",
        "unverified_frontier",
        _surgery(g, edit),
        tgt.src,
    )


# ---------------------------------------------------------------------------
# category 2: incorrect distributed configuration


@DEFAULT_INJECTORS.injector(
    "wrong_replica_groups", category="wrong_replica_groups",
    site_op="all_reduce",
    doc="all_reduce over half-mesh replica groups instead of the full axis")
def wrong_replica_groups(g: Graph, index: int = 0) -> Optional[Injection]:
    tgt = _find(g, "all_reduce", index=index)
    if tgt is None:
        return None

    def edit(ng: Graph, n: Node, remap):
        if n.id == tgt.id:
            return ng.add(n.op, [remap[i] for i in n.inputs], n.shape, n.dtype,
                          _remap_params(n.params, groups=((0, 1), (2, 3))),
                          src=n.src, layer=n.layer, scope=n.scope)
        return None

    return Injection(
        f"wrong_replica_groups@{index}",
        f"all_reduce at {tgt.src} reduced over half-groups only",
        "wrong_replica_groups",
        _surgery(g, edit),
        tgt.src,
    )


@DEFAULT_INJECTORS.injector(
    "wrong_collective_axis", category="wrong_mesh_axis",
    site_op="all_reduce",
    doc="all_reduce over a mesh axis the program's mesh never declared")
def wrong_collective_axis(g: Graph, index: int = 0) -> Optional[Injection]:
    tgt = _find(g, "all_reduce", index=index)
    if tgt is None:
        return None

    def edit(ng: Graph, n: Node, remap):
        if n.id == tgt.id:
            return ng.add(n.op, [remap[i] for i in n.inputs], n.shape, n.dtype,
                          _remap_params(n.params, axes=("pipeline",)),
                          src=n.src, layer=n.layer, scope=n.scope)
        return None

    return Injection(
        f"wrong_collective_axis@{index}",
        f"all_reduce at {tgt.src} reduces over undeclared axis 'pipeline'",
        "wrong_mesh_axis",
        _surgery(g, edit),
        tgt.src,
    )


# ---------------------------------------------------------------------------
# category 3: inconsistent tensor precision


@DEFAULT_INJECTORS.injector(
    "precision_drop", category="precision_mismatch", site_op="dot",
    doc="matmul computed in a lower dtype with a silent upcast")
def precision_drop(g: Graph, index: int = 0) -> Optional[Injection]:
    tgt = _find(g, "dot", lambda n: n.dtype in ("float32", "bfloat16"), index)
    if tgt is None:
        return None
    low = "bfloat16" if tgt.dtype == "float32" else "float16"

    def edit(ng: Graph, n: Node, remap):
        if n.id == tgt.id:
            dot = ng.add(n.op, [remap[i] for i in n.inputs], n.shape, low,
                         {k: v for k, v in n.params}, src=n.src, layer=n.layer, scope=n.scope)
            return ng.add("convert", [dot], n.shape, n.dtype,
                          {"new_dtype": n.dtype}, src=n.src, layer=n.layer, scope=n.scope)
        return None

    return Injection(
        f"precision_drop@{index}",
        f"dot at {tgt.src} computed in {low} with silent upcast",
        "precision_mismatch",
        _surgery(g, edit),
        tgt.src,
    )


# ---------------------------------------------------------------------------
# category 4: incorrect axis splitting (the BSH reshape bug, Fig. 1)


@DEFAULT_INJECTORS.injector(
    "swap_reshape_dims", category="layout_mismatch", site_op="reshape",
    doc="reshape swaps leading dims then transposes back (Fig. 1 BSH bug)")
def swap_reshape_dims(g: Graph, index: int = 0) -> Optional[Injection]:
    def pred(n: Node) -> bool:
        s = n.shape
        return len(s) >= 2 and s[0] != s[1] and s[0] > 1 and s[1] > 1

    tgt = _find(g, "reshape", pred, index)
    if tgt is None:
        return None
    bad = (tgt.shape[1], tgt.shape[0]) + tgt.shape[2:]

    def edit(ng: Graph, n: Node, remap):
        if n.id == tgt.id:
            r = ng.add("reshape", [remap[n.inputs[0]]], bad, n.dtype,
                       {"new_sizes": bad}, src=n.src, layer=n.layer, scope=n.scope)
            # transpose back so downstream shapes still match (the silent part)
            perm = (1, 0) + tuple(range(2, len(bad)))
            return ng.add("transpose", [r], n.shape, n.dtype,
                          {"permutation": perm}, src=n.src, layer=n.layer, scope=n.scope)
        return None

    return Injection(
        f"swap_reshape_dims@{index}",
        f"reshape at {tgt.src} swaps leading dims then transposes (BSH bug)",
        "layout_mismatch",
        _surgery(g, edit),
        tgt.src,
    )


# ---------------------------------------------------------------------------
# category 5: incorrect layout optimization


@DEFAULT_INJECTORS.injector(
    "wrong_transpose", category="layout_mismatch", site_op="transpose",
    doc="transpose uses a wrong permutation, reshaped back to shape")
def wrong_transpose(g: Graph, index: int = 0) -> Optional[Injection]:
    # swapping the first two output dims must MOVE data (both dims > 1),
    # otherwise the mutation is a unit-dim no-op the verifier rightly accepts
    tgt = _find(g, "transpose",
                lambda n: len(n.shape) >= 2 and n.shape[0] > 1 and n.shape[1] > 1,
                index)
    if tgt is None:
        return None
    perm = list(tgt.param("permutation"))
    perm[0], perm[1] = perm[1], perm[0]
    in_shape = None

    def edit(ng: Graph, n: Node, remap):
        nonlocal in_shape
        if n.id == tgt.id:
            src_shape = ng[remap[n.inputs[0]]].shape
            new_shape = tuple(src_shape[p] for p in perm)
            t = ng.add("transpose", [remap[n.inputs[0]]], new_shape, n.dtype,
                       {"permutation": tuple(perm)}, src=n.src, layer=n.layer, scope=n.scope)
            if new_shape != n.shape:
                return ng.add("reshape", [t], n.shape, n.dtype,
                              {"new_sizes": n.shape}, src=n.src, layer=n.layer, scope=n.scope)
            return t
        return None

    return Injection(
        f"wrong_transpose@{index}",
        f"transpose at {tgt.src} uses a wrong permutation",
        "layout_mismatch",
        _surgery(g, edit),
        tgt.src,
    )


@DEFAULT_INJECTORS.injector(
    "wrong_all_gather_dim", category="layout_mismatch", site_op="all_gather",
    doc="all_gather concatenates along the wrong dimension")
def wrong_all_gather_dim(g: Graph, index: int = 0) -> Optional[Injection]:
    tgt = _find(g, "all_gather", lambda n: len(n.shape) >= 2, index)
    if tgt is None:
        return None
    dim = tgt.param("all_gather_dimension", 0)
    new_dim = (dim + 1) % len(tgt.shape)

    def edit(ng: Graph, n: Node, remap):
        if n.id == tgt.id:
            src_shape = ng[remap[n.inputs[0]]].shape
            c = n.shape[dim] // src_shape[dim]
            new_shape = list(src_shape)
            new_shape[new_dim] = new_shape[new_dim] * c
            gathered = ng.add("all_gather", [remap[n.inputs[0]]], tuple(new_shape), n.dtype,
                              _remap_params(n.params, all_gather_dimension=new_dim),
                              src=n.src, layer=n.layer, scope=n.scope)
            return ng.add("reshape", [gathered], n.shape, n.dtype,
                          {"new_sizes": n.shape}, src=n.src, layer=n.layer, scope=n.scope)
        return None

    return Injection(
        f"wrong_all_gather_dim@{index}",
        f"all_gather at {tgt.src} gathers along dim {new_dim} instead of {dim}",
        "layout_mismatch",
        _surgery(g, edit),
        tgt.src,
    )


@DEFAULT_INJECTORS.injector(
    "wrong_scatter_dim", category="layout_mismatch", site_op="reduce_scatter",
    doc="reduce_scatter splits along the wrong dimension (SP-style bug)")
def wrong_scatter_dim(g: Graph, index: int = 0) -> Optional[Injection]:
    """reduce_scatter along the wrong dimension (sequence-parallel bug:
    scattering hidden instead of sequence), reshaped back so downstream
    shapes still match — the silent part."""

    tgt = _find(g, "reduce_scatter",
                lambda n: len(n.shape) >= 2 and bool(n.inputs), index)
    if tgt is None:
        return None
    dim = tgt.param("scatter_dimension", 0)
    in_shape = g[tgt.inputs[0]].shape
    c = in_shape[dim] // tgt.shape[dim]
    new_dim = next((i for i in range(len(in_shape))
                    if i != dim and in_shape[i] % c == 0), None)
    if new_dim is None:
        return None

    def edit(ng: Graph, n: Node, remap):
        if n.id == tgt.id:
            src_shape = ng[remap[n.inputs[0]]].shape
            new_shape = list(src_shape)
            new_shape[new_dim] = new_shape[new_dim] // c
            scat = ng.add("reduce_scatter", [remap[n.inputs[0]]],
                          tuple(new_shape), n.dtype,
                          _remap_params(n.params, scatter_dimension=new_dim),
                          src=n.src, layer=n.layer, scope=n.scope)
            return ng.add("reshape", [scat], n.shape, n.dtype,
                          {"new_sizes": n.shape}, src=n.src, layer=n.layer,
                          scope=n.scope)
        return None

    return Injection(
        f"wrong_scatter_dim@{index}",
        f"reduce_scatter at {tgt.src} scatters along dim {new_dim} instead of {dim}",
        "layout_mismatch",
        _surgery(g, edit),
        tgt.src,
    )


@DEFAULT_INJECTORS.injector(
    "shifted_slice", category="unverified_frontier", site_op="slice",
    doc="slice start off by one (KV-cache style misslice)")
def shifted_slice(g: Graph, index: int = 0) -> Optional[Injection]:
    def pred(n: Node) -> bool:
        st = n.param("start_indices")
        return st is not None and any(s > 0 for s in st)

    tgt = _find(g, "slice", pred, index)
    if tgt is None:
        return None
    st = list(tgt.param("start_indices"))
    li = list(tgt.param("limit_indices"))
    k = next(i for i, s in enumerate(st) if s > 0)
    st[k] -= 1
    li[k] -= 1

    def edit(ng: Graph, n: Node, remap):
        if n.id == tgt.id:
            return ng.add("slice", [remap[n.inputs[0]]], n.shape, n.dtype,
                          _remap_params(n.params, start_indices=tuple(st),
                                        limit_indices=tuple(li)),
                          src=n.src, layer=n.layer, scope=n.scope)
        return None

    return Injection(
        f"shifted_slice@{index}",
        f"slice at {tgt.src} off by one on dim {k} (KV-cache style misslice)",
        "unverified_frontier",
        _surgery(g, edit),
        tgt.src,
    )


# Deprecated alias: the plain function list predating DEFAULT_INJECTORS.
# Kept for back-compat (benchmarks, external callers); registry order.
ALL_INJECTORS = [s.fn for s in DEFAULT_INJECTORS.specs()]


def inject_all(g: Graph) -> list[Injection]:
    out = []
    for spec in DEFAULT_INJECTORS.specs():
        r = spec(g)
        if r is not None:
            out.append(r)
    return out
