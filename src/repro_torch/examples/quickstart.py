"""Quickstart: verify a Megatron-style TP parallelization with the port.

Runs on the CPU (tracing only: fake tensors under a fake process group, no
multi-device runtime needed):

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
import inspect

import torch

from repro_torch.configs.base import ShapeDtype
from repro_torch.core import trace, trace_sharded, verify_graphs
from repro_torch.core.inject import drop_all_reduce
from repro_torch.core.relations import DUP, SHARD
from repro_torch.core.verifier import InputFact, OutputSpec
from repro_torch.parallel.sharding import P
from repro_torch.scope import named_scope
from repro_torch.verify import Session

B, H, F, LAYERS, TP = 4, 64, 256, 4, 8


def baseline(x, w1s, w2s):
    """Trusted single-device MLP stack."""
    for i in range(LAYERS):
        with named_scope(f"layer{i}"):
            x = torch.tanh(x @ w1s[i]) @ w2s[i] + x
    return x


def distributed(ctx, x, w1s, w2s):
    """Tensor-parallel version: column/row sharded with one psum per layer."""
    for i in range(LAYERS):
        with named_scope(f"layer{i}"):
            x = ctx.psum_tp(torch.tanh(x @ w1s[i]) @ w2s[i]) + x
    return x


def main() -> None:
    avals = (ShapeDtype((B, H), torch.float32),
             ShapeDtype((LAYERS, H, F), torch.float32),
             ShapeDtype((LAYERS, F, H), torch.float32))
    specs = (P(), P(None, None, "model"), P(None, "model", None))

    print("=== 1. verify the correct parallelization ===")
    report = Session().verify_sharded(baseline, distributed, *avals, size=TP,
                                      in_specs=specs,
                                      output_specs=[OutputSpec(kind="dup")])
    print(report.summary())
    assert report.verified

    print("\n=== 2. inject a missing all-reduce and catch it ===")
    gb, b_in, _ = trace(baseline, *avals, name="base")
    gd, d_in, _ = trace_sharded(distributed, TP, specs, *avals)
    bug = drop_all_reduce(gd, index=1)
    facts = [InputFact(DUP, 0, 0), InputFact(SHARD, 1, 1, 2), InputFact(SHARD, 2, 2, 1)]
    report = verify_graphs(gb, bug.graph, size=TP, input_facts=facts,
                           base_inputs=b_in, dist_inputs=d_in,
                           output_specs=[OutputSpec(kind="dup")])
    print(report.summary())
    assert not report.verified
    # the dropped all_reduce runs in ParallelCtx (bug.site); the line that
    # calls it is this file's
    lines, first = inspect.getsourcelines(distributed)
    call = first + next(i for i, ln in enumerate(lines) if "psum_tp" in ln)
    site = f"quickstart.py:{call}"
    localized = any(b.src == site for b in report.bug_sites)
    print(f"\ninjected at: {site} ({bug.site})  -> localized: {localized}")
    assert localized


if __name__ == "__main__":
    main()
