"""PartitionSpec -> input/output relation registration (shared helper).

One home for the spec-to-fact logic that was previously duplicated between
``core/verifier.py`` (``verify_sharded``) and ``core/modelverify.py``
(``_spec_input_facts``): a spec that shards dim ``d`` along ``axis``
registers ``sharded(b_i, d_i, dim=d)``; a replicated spec registers
``duplicate``.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.relations import DUP, SHARD
from repro_torch.core.verifier import InputFact, OutputSpec


def shard_dim(spec, axis: str = "model") -> Optional[int]:
    """Dim sharded along ``axis`` in a PartitionSpec, or None (replicated).
    The last occurrence wins, matching jax's right-to-left spec semantics
    for repeated axis names (which are invalid anyway)."""
    dim = None
    for d, entry in enumerate(tuple(spec)):
        names = entry if isinstance(entry, tuple) else (entry,)
        if axis in [n for n in names if n]:
            dim = d
    return dim


def spec_input_facts(flat_specs: Sequence, axis: str = "model") -> list[InputFact]:
    """Input relation registration straight from flattened sharding specs."""
    facts = []
    for i, spec in enumerate(flat_specs):
        dim = shard_dim(spec, axis)
        facts.append(
            InputFact(SHARD if dim is not None else DUP, i, i,
                      -1 if dim is None else dim))
    return facts


def spec_output_specs(flat_specs: Sequence, axis: str = "model") -> list[OutputSpec]:
    """Expected output placements from flattened sharding specs."""
    out = []
    for spec in flat_specs:
        dim = shard_dim(spec, axis)
        out.append(OutputSpec(kind="shard" if dim is not None else "dup",
                              dim=-1 if dim is None else dim))
    return out
