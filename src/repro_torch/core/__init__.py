"""The port's verifier core: semantic-equivalence verification of
computational graphs via e-graph rewriting, Datalog-style relation
propagation, and symbolic bijection inference, over the same TensorIR as the
JAX package (everything but the tracer is the same code).

Public API:
    verify_sharded(base_fn, dist_fn, *avals, ...) -> Report
    verify_graphs(base, dist, ...) -> Report
    trace / trace_sharded  -> TensorIR graphs from torch functions (make_fx)
    inject  -> silent-error injection for testing/benchmarks
"""
from .bijection import Layout, NotSplitMerge, infer_bijection, layout_of_ops
from .egraph import EGraph, GraphEGraph
from .inject import ALL_INJECTORS, Injection, inject_all
from .ir import Graph, Node
from .partition import (
    PartitionedVerifier,
    TemplateCache,
    partition_layers,
    topological_stages,
)
from .relations import DUP, PARTIAL, SHARD, Fact, RelStore
from .report import BugSite, CacheStats, PhaseTimings, Report, severity_of
from .rules import DEFAULT_REGISTRY, Propagator, RuleRegistry, WorklistEngine
from .trace import trace, trace_sharded
from .verifier import (
    InputFact,
    OutputSpec,
    VerifyOptions,
    localize,
    verify_graphs,
    verify_sharded,
)

__all__ = [
    "Layout", "NotSplitMerge", "infer_bijection", "layout_of_ops",
    "EGraph", "GraphEGraph", "Graph", "Node",
    "DUP", "SHARD", "PARTIAL", "Fact", "RelStore", "Propagator",
    "DEFAULT_REGISTRY", "RuleRegistry", "WorklistEngine",
    "PartitionedVerifier", "TemplateCache", "partition_layers",
    "topological_stages",
    "trace", "trace_sharded",
    "BugSite", "CacheStats", "InputFact", "OutputSpec", "PhaseTimings",
    "Report", "VerifyOptions", "severity_of",
    "localize", "verify_graphs", "verify_sharded",
    "ALL_INJECTORS", "Injection", "inject_all",
]
