"""Scope meta rules (vendor-kernel granularity, paper §5.1): match named-
scope regions against trusted templates.  The template is the *same
function* the framework uses to generate the region
(parallel/collectives.py); structural identity is checked by fingerprint,
so any mutation of the region stays unverified.

Meta rules scan the whole graph (regions straddle partition stages); the
group scan is cached on the Propagator — the graph is static.  Both engines
re-apply them after each pass / worklist drain until they fire nothing new.
"""
from __future__ import annotations

import numpy as np

from ..bijection import Layout
from ..relations import DUP, PARTIAL, SHARD, Fact

# template fingerprints are pure functions of (variant, shapes, dtype, size):
# cache process-wide, like the old Propagator class attribute did
_vp_embed_templates: dict = {}
# (axis size, partial) -> whether the template's generator computes the lookup
_generator_checked: dict = {}


def apply_meta_rules(prop) -> None:
    if not hasattr(prop, "_meta_groups"):
        groups: dict[str, list[int]] = {}
        for n in prop.dist:
            parts = n.scope.split("/")
            if "vp_embed" in parts or "vp_embed_sp" in parts:
                groups.setdefault(n.scope, []).append(n.id)
        prop._meta_groups = []
        for scope, nids in groups.items():
            # scope tags are lost inside library internals (jnp.take's
            # custom_jvp); the region is the contiguous trace span
            lo, hi = min(nids), max(nids)
            span = [
                i for i in range(lo, hi + 1)
                if prop.dist[i].op not in ("input", "param")
            ]
            prop._meta_groups.append((span, scope))
    for span, scope in prop._meta_groups:
        _meta_vp_embed(prop, span, scope)


def _meta_vp_embed(prop, nids: list[int], scope: str = "vp_embed") -> None:
    g = prop.dist
    inside = set(nids)
    # "vp_embed_sp": the sequence-parallel variant — the region is the
    # *partial* (masked local lookup, no reduction); the escaping node is
    # the mask product and it earns a partial(add) fact the downstream
    # reduce_scatter discharges through the ordinary collective rule.
    partial = "vp_embed_sp" in scope.split("/")
    if partial:
        outs = [nid for nid in nids
                if g[nid].op == "mul"
                and (any(c not in inside for c in g.consumers(nid))
                     or nid in g.outputs)]
    else:
        # region output: the all_reduce whose consumers escape the region
        outs = [nid for nid in nids
                if g[nid].op == "all_reduce"
                and (any(c not in inside for c in g.consumers(nid))
                     or nid in g.outputs)]
    if len(outs) != 1 or prop.store.verified(outs[0]):
        return
    out = outs[0]
    # external inputs: the sharded table + the replicated ids
    ext = []
    for nid in nids:
        for i in g[nid].inputs:
            if i not in inside and i not in ext:
                ext.append(i)
    table = ids = None
    tfact = ifact = None
    for e in ext:
        for f in prop.store.facts(e):
            if f.kind == SHARD and prop._shard_src_dim(f) == 0 and len(g[e].shape) == 2:
                table, tfact = e, f
            elif f.kind == DUP and f.layout.is_identity and "int" in g[e].dtype:
                ids, ifact = e, f
    if table is None or ids is None:
        return
    # template fingerprint: trace the trusted generator with these shapes
    if not _vp_embed_template_ok(prop, nids, g[table].shape, g[ids].shape,
                                 g[table].dtype, partial=partial):
        prop.store.diag(
            out, "layout_mismatch",
            "vp_embed region deviates from the trusted template")
        return
    # baseline counterpart: gather(full_table, idx) with idx derived from
    # ids through layout-only ops (jnp.take inserts a broadcast)
    def derives_from(nid: int, target: int, depth: int = 8) -> bool:
        if prop.base_eg.same(nid, target):
            return True
        if depth == 0:
            return False
        n = prop.base[nid]
        # jnp.take inserts clip (max/min against consts) + broadcast; all
        # value-preserving for in-range token ids on the trusted baseline
        if n.op in ("broadcast", "reshape", "transpose", "convert", "max",
                    "min", "clamp", "select", "add", "lt", "ge"):
            return any(derives_from(i, target, depth - 1) for i in n.inputs)
        return False

    for zid in prop.base.consumers(tfact.base):
        z = prop.base[zid]
        if z.op == "gather" and len(z.inputs) == 2 and derives_from(
                z.inputs[1], ifact.base) and z.dtype == g[out].dtype:
            # the port's single-device lookup keeps jnp.take's NaN fill for
            # ids out of range as a select after the gather (the JAX gather
            # carries it inside): the region's output is that select
            zid = _nan_fill_select(prop, zid, ifact.base, derives_from) or zid
            if partial:
                prop.emit(Fact(PARTIAL, zid, out, prop.size,
                               Layout.identity(z.shape), reduce_op="add"))
            else:
                prop.emit(Fact(DUP, zid, out, prop.size,
                               Layout.identity(z.shape)))
            prop.store.covered_scopes.add(scope)
            prop.store.covered_nodes.update(nids)
            return


def _nan_fill_select(prop, zid: int, ids: int, derives_from):
    """The node ``select(in_range(w), nan, gather)`` that consumes gather
    ``zid``, where ``in_range(w)`` is exactly ``(w >= 0) & (w < V)`` for the
    full table's row count ``V`` and ``w`` derives from the token ids; None
    when ``zid`` has no such consumer (then the gather is the output)."""
    base = prop.base
    z = base[zid]
    V = base[z.inputs[0]].shape[0]
    for sid in base.consumers(zid):
        s = base[sid]
        if s.op != "select" or len(s.inputs) != 3 or s.inputs[2] != zid:
            continue
        if not _is_nan_const(base, s.inputs[1]) or s.shape != z.shape:
            continue
        pred = _strip_layout(base, s.inputs[0])
        if base[pred].op != "and" or len(base[pred].inputs) != 2:
            continue
        bounds = {}
        for c in base[pred].inputs:
            n = base[c]
            if n.op in ("ge", "lt") and len(n.inputs) == 2:
                k = base[n.inputs[1]]
                if k.op == "const" and k.param("value") is not None:
                    bounds[n.op] = (n.inputs[0], k.param("value"))
        if (set(bounds) == {"ge", "lt"} and bounds["ge"][1] == 0
                and bounds["lt"][1] == V and bounds["ge"][0] == bounds["lt"][0]
                and derives_from(bounds["ge"][0], ids)):
            return sid
    return None


def _strip_layout(g, nid: int) -> int:
    while g[nid].op in ("broadcast", "reshape") and len(g[nid].inputs) == 1:
        nid = g[nid].inputs[0]
    return nid


def _is_nan_const(g, nid: int) -> bool:
    from ..trace import _NP_DTYPES, DTYPE_NAMES, _const_hash

    n = g[_strip_layout(g, nid)]
    np_dtype = {v: _NP_DTYPES[k] for k, v in DTYPE_NAMES.items()}.get(n.dtype)
    return (n.op == "const" and n.shape == () and np_dtype is not None
            and n.param("value_hash") == _const_hash(np.asarray(np.nan, np_dtype)))


def _vp_embed_template_ok(prop, nids, table_shape, ids_shape, dtype,
                          partial: bool = False) -> bool:
    if not _generator_ok(prop.size, partial):
        return False
    key = (partial, tuple(table_shape), tuple(ids_shape), dtype, prop.size)
    if key not in _vp_embed_templates:
        import dataclasses

        from repro_torch.parallel import collectives
        from repro_torch.parallel.sharding import P

        from ..trace import DTYPE_NAMES, ShapeDtype, trace_sharded

        gen = collectives.vp_embed_sp if partial else collectives.vp_embed
        torch_dtype = {v: k for k, v in DTYPE_NAMES.items()}
        tbl = ShapeDtype((table_shape[0] * prop.size, table_shape[1]),
                         torch_dtype[dtype])
        idv = ShapeDtype(tuple(ids_shape), torch_dtype["int64"])
        gt, _, _ = trace_sharded(
            lambda ctx, t, i: gen(t, i, dataclasses.replace(ctx, sp=partial)),
            prop.size, (P(prop.axis, None), P()), tbl, idv, axis=prop.axis)
        # the template's reduction is checked too: one collective, a sum
        # over the region's axis, and it is the template's output; an
        # all_reduce inside the region, or under SP a reduce_scatter along
        # the sequence (dim 1), outside it
        reduces = [n for n in gt if n.op in ("all_reduce", "all_gather",
                                             "reduce_scatter")]
        r = reduces[0] if len(reduces) == 1 else None
        if r is None or not (
                r.op == ("reduce_scatter" if partial else "all_reduce")
                and r.param("reduce_op") == "add"
                and tuple(r.param("axes")) == (prop.axis,)
                and (not partial or r.param("scatter_dimension") == 1)
                and list(gt.outputs) == [r.id]):
            _vp_embed_templates[key] = None
        else:
            body = [n.id for n in gt if n.op not in ("input", "param", "const")
                    and not (partial and n.id == r.id)]
            _vp_embed_templates[key] = gt.fingerprint(sorted(body),
                                                      normalize_slices=True)
    if _vp_embed_templates[key] is None:
        return False
    region_fp = prop.dist.fingerprint(
        sorted(n for n in nids if prop.dist[n].op not in ("const",)),
        normalize_slices=True)
    # consts participate as ext leaves in both fingerprints via inputs
    return region_fp == _vp_embed_templates[key]


class _RankCtx:
    """One rank of the template's context, in one process: the rank tensor,
    and a ``psum_tp`` (``vp_embed``) and an ``sp_enter`` (``vp_embed_sp``)
    that return what they were asked to sum, wrapped with how, for
    ``_generator_ok`` to add up over ranks.  The template may call no other
    method of the context."""

    def __init__(self, rank: int):
        self.rank = rank

    def tp_index(self):
        import torch

        return torch.tensor(self.rank)

    def psum_tp(self, x):
        return _Summed(x, "psum")

    def sp_enter(self, x, seq_axis: int = 1):
        return _Summed(x, f"scatter{seq_axis}")


class _Summed:
    def __init__(self, x, how: str):
        self.x = x
        self.how = how


def _generator_ok(size: int, partial: bool = False) -> bool:
    """The trusted generator is checked, not assumed: on a small table
    (``V_loc`` = 3 rows a rank, values of both signs), ``vp_embed`` (or,
    ``partial``, ``vp_embed_sp``) run on every rank with its collective
    emulated over ranks equals the plain lookup for every id in range, and
    is zero past it.  A reduction other than the sum (under SP: other than
    the reduce_scatter along the sequence), or work after it, fails the
    check."""
    if (size, partial) not in _generator_checked:
        import torch

        from repro_torch.parallel import collectives

        gen = collectives.vp_embed_sp if partial else collectives.vp_embed
        V_loc, V = 3, 3 * size
        table = torch.arange(1, V * 2 + 1, dtype=torch.float32).reshape(V, 2)
        table = table * torch.tensor([1.0, -1.0])
        ids = torch.arange(-2, V + 2).reshape(1, -1)
        try:
            outs = [gen(table[r * V_loc:(r + 1) * V_loc], ids, _RankCtx(r))
                    for r in range(size)]
        except (AttributeError, TypeError):  # another collective, or work after it
            outs = []
        how = "scatter1" if partial else "psum"
        ok = bool(outs) and all(isinstance(o, _Summed) and o.how == how for o in outs)
        if ok:
            total = sum(o.x for o in outs)
            valid = ((ids >= 0) & (ids < V))[..., None]
            want = torch.where(valid, table[ids.clamp(0, V - 1)], 0.0)
            ok = torch.equal(total, want)
        _generator_checked[(size, partial)] = ok
    return _generator_checked[(size, partial)]
