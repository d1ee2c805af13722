"""Datalog-style relation propagation rules (paper §5.2.2, Table 1).

The monolithic Propagator is decomposed into a registry-driven rule engine:

* :mod:`.registry`    — :class:`RuleRegistry`: op-family rules as declarative
  units carrying the ops they handle and the fact kinds they consume;
* :mod:`.propagator`  — the :class:`Propagator` matching context + the
  pass-based reference engine;
* :mod:`.engine`      — :class:`WorklistEngine`: semi-naive worklist
  evaluation (nodes re-fire only when an input gained a fact);
* one module per op family: :mod:`.congruence`, :mod:`.elementwise`,
  :mod:`.layout`, :mod:`.dot`, :mod:`.reduce`, :mod:`.collective`,
  :mod:`.sliceops`, :mod:`.meta`.

``from repro.core.rules import Propagator`` keeps working unchanged.
"""
from .common import LINEAR_UNARY, dup_id, move_dim, shard_stack_layout
from .registry import DEFAULT_REGISTRY, Rule, RuleRegistry
from .propagator import Propagator

# importing the family modules populates DEFAULT_REGISTRY; congruence must
# come first so its generic rule fires before op-specific rules that share
# an op (pad, concat, cumsum, rev, dynamic_slice, ...)
from . import congruence  # noqa: E402  (registration side effects)
from . import elementwise, layout, dot, reduce, collective, sliceops, meta  # noqa: E402,F401

from .engine import WorklistEngine

# legacy private-name aliases (the pre-package module exposed these)
_move_dim = move_dim
_shard_stack_layout = shard_stack_layout
_dup_id = dup_id

__all__ = [
    "DEFAULT_REGISTRY", "LINEAR_UNARY", "Propagator", "Rule", "RuleRegistry",
    "WorklistEngine", "dup_id", "move_dim", "shard_stack_layout",
]
