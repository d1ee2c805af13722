"""Retired relational rules, kept verbatim as the fusion-off fallback.

The equality-saturation tier (:mod:`repro.core.rules.fusion`) subsumes these
rules: iota and off-axis axis_index are pure functions of their attributes,
so the fusion e-graph content-addresses them as shared leaves and the
congruent-class discharge emits the identity-DUP facts these rules used to
derive one pair at a time.

When the tier is disabled (``VerifyOptions(fusion=False)``, chunk-shard
workers, or direct ``Propagator(...)`` construction), the verifier must not
lose coverage — ``legacy_registry()`` clones the default registry and
re-registers the retired rules, so fusion-off runs produce the exact same
fact sets as before the retirement.  This mirrors how the pass-based engine
is kept purely as a parity reference (ROADMAP standing note): the retired
rules are the parity reference for the discharge path, and the
fusion-parity tests compare the two fact-for-fact.
"""
from __future__ import annotations

from typing import Optional

from ..bijection import Layout
from ..ir import Node
from ..relations import DUP, Fact
from .registry import DEFAULT_REGISTRY, RuleRegistry


def iota_congruence(prop, d: Node) -> None:
    """iota is a pure function of (shape, dtype, params): congruent iotas
    in both graphs are duplicates (layer-filtered: cross-layer pairings
    are redundant and blow up the join-combo search)."""
    for b in prop.base:
        if (b.op == "iota" and b.shape == d.shape and b.dtype == d.dtype
                and b.params == d.params):
            if d.layer is not None and b.layer is not None and b.layer != d.layer:
                continue
            prop.emit(Fact(DUP, b.id, d.id, prop.size, Layout.identity(b.shape)))


def axis_index_congruence(prop, d: Node) -> None:
    """axis_index over a *different* axis than the one verified is the same
    value at every rank of the verified axis — congruent-dup with the
    baseline axis_index carrying identical params (composite plans: the
    baseline per-device program queries its own rank the same way)."""
    axes = d.param("axes") or ()
    if prop.axis in tuple(axes):
        return  # rank-dependent along the verified axis: no relation
    cache = getattr(prop, "_axis_index_bases", None)
    if cache is None:
        cache = {}
        for b in prop.base:
            if b.op == "axis_index":
                cache.setdefault(b.params, []).append(b.id)
        prop._axis_index_bases = cache
    for zid in cache.get(d.params, []):
        z = prop.base[zid]
        if z.dtype == d.dtype and z.shape == d.shape:
            prop.emit(Fact(DUP, zid, d.id, prop.size, Layout.identity(z.shape)))


_LEGACY: Optional[RuleRegistry] = None


def legacy_registry() -> RuleRegistry:
    """The default registry plus the retired rules (lazily built + cached).

    Must be called after the rules package is fully imported (any
    Propagator construction qualifies) — it snapshots DEFAULT_REGISTRY."""
    global _LEGACY
    if _LEGACY is None:
        reg = RuleRegistry()
        reg.rules = list(DEFAULT_REGISTRY.rules)
        reg._by_op = {op: list(rs) for op, rs in DEFAULT_REGISTRY._by_op.items()}
        reg._fallback = list(DEFAULT_REGISTRY._fallback)
        reg.rule("iota_congruence", ("iota",), produces=(DUP,))(iota_congruence)
        reg.rule("axis_index_congruence", ("axis_index",),
                 produces=(DUP,))(axis_index_congruence)
        _LEGACY = reg
    return _LEGACY
