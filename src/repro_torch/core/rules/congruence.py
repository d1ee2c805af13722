"""Congruence rules: dup-in/dup-out for any op, plus leaf congruence for
constants and iota (pure functions of their attributes).

``generic`` is the registry fallback — opaque ops verify only when both
sides have congruent nodes with replicated operands (sound default)."""
from __future__ import annotations

import itertools

from ..bijection import Layout
from ..ir import Node
from ..relations import DUP, Fact
from .registry import DEFAULT_REGISTRY as R

# ops that get the generic rule *in addition to* an op-specific rule
# (must be registered before the specific modules are imported so the
# congruence pass fires first, as the monolithic handlers did)
GENERIC_EXTRA_OPS = (
    "pad", "cumsum", "rev", "dynamic_slice", "dynamic_update_slice", "concat",
    "gather", "scatter", "scatter_add",
)

# leaves and pure-routing ops fire no rules.  iota and axis_index are here
# because their former congruence rules are retired: the fusion tier
# content-addresses both as shared e-graph leaves and discharges the DUP
# facts via congruent-class scan (rules/fusion.py); fusion-off runs get the
# originals back via rules/legacy.py's legacy_registry().
R.noop("input", "param", "axis_index", "ppermute", "iota")


@R.fallback("generic_congruence", consumes=(DUP,), produces=(DUP,))
@R.rule("generic_congruence", GENERIC_EXTRA_OPS, consumes=(DUP,),
        produces=(DUP,))
def generic(prop, d: Node) -> None:
    """All inputs dup with (effectively) identity layout -> congruent
    baseline node is a duplicate."""
    if not d.inputs:
        return
    fact_lists = [prop.store.facts(i) for i in d.inputs]
    if not all(fact_lists):
        return
    choices = []
    for fl in fact_lists:
        pick = [f for f in fl if f.kind == DUP and f.layout.effectively_identity]
        if not pick:
            return
        choices.append(pick)
    for combo in itertools.product(*[c[:4] for c in choices]):
        b_inputs = [f.base for f in combo]
        for z in prop._base_candidates(d.op, b_inputs, d.params, layer=d.layer):
            if z.shape == d.shape and prop._dtype_ok(z, d):
                prop.emit(Fact(DUP, z.id, d.id, prop.size, Layout.identity(z.shape)))


@R.rule("const_congruence", ("const",), produces=(DUP,))
def const(prop, d: Node) -> None:
    # constants with identical payload hash in both graphs: congruent leaf
    val = d.param("value_hash")
    if val is None:
        return
    for b in prop.base:
        if b.op == "const" and b.param("value_hash") == val and b.shape == d.shape and b.dtype == d.dtype:
            if d.layer is not None and b.layer is not None and b.layer != d.layer:
                continue
            prop.emit(Fact(DUP, b.id, d.id, prop.size, Layout.identity(b.shape)))
            break  # congruent consts share an eclass: one pairing suffices
