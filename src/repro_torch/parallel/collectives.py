"""Shared distributed building blocks with registered verification templates.

Functions here are used by BOTH the model code and the verifier's meta-rule
template generation: the verifier traces these exact functions with its own
tracer to obtain the trusted subgraph fingerprint it accepts at "vendor
kernel" granularity (``repro_torch.core.rules.meta``).  Any mutation of the
generated subgraph changes the fingerprint and the region stays unverified.
"""
from __future__ import annotations

from repro_torch.scope import named_scope


def vp_embed_partial(table, ids, rank):
    """Vocab-parallel embedding *partial*: local-chunk lookup + range mask,
    no reduction: the per-rank contribution whose sum over ranks is the full
    lookup.

    table: (V_loc, D) this rank's vocab rows; ids: integer tokens (any shape);
    rank: this rank's index, a 0-d int64 tensor.
    """
    V_loc = table.shape[0]
    off = rank * V_loc
    local = (ids - off).clamp(0, V_loc - 1)
    x = table[local]
    mask = ((ids >= off) & (ids < off + V_loc))[..., None]
    return x * mask.to(x.dtype)


def vp_embed(table, ids, ctx):
    """Vocab-parallel embedding: local-chunk lookup + range mask + psum over
    the context's tensor-parallel axis."""
    return ctx.psum_tp(vp_embed_partial(table, ids, ctx.tp_index()))


def vp_embed_sp(table, ids, ctx):
    """Sequence-parallel vocab embedding: the partial lookup in a
    ``vp_embed_sp`` scope (the region the verifier's meta rule trusts), then
    the reduce_scatter along the sequence that enters the SP region
    (``ctx.sp_enter``), outside the scope, where the ordinary collective
    rule discharges it."""
    with named_scope("vp_embed_sp"):
        x = vp_embed_partial(table, ids, ctx.tp_index())
    return ctx.sp_enter(x)
