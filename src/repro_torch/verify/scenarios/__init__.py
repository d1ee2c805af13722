"""repro_torch.verify.scenarios — the registry-driven scenario subsystem.

Every parallelism axis the verifier covers is one registered
:class:`~repro_torch.verify.scenarios.registry.ScenarioSpec`: a builder
declaring its mesh axis, input shapes and base/distributed trace functions
once, over the shared trace/stamp/spec plumbing in :mod:`.harness`.

Registered kinds (see ``python -m repro_torch.verify --list``):

``tp-forward``     baseline forward vs TP-sharded per-rank forward
``tp-decode``      one serving step against head-sharded KV/SSM caches
``dp-forward``     batch-sharded forward (cross-batch interaction)
``dp-grad``        per-device sum-loss gradients + psum vs full-batch
                   gradients (the DP gradient-sync contract)
``sp-forward``     sequence-parallel forward (reduce_scatter/all_gather
                   around the norm regions vs the psum baseline)
``ep-moe-forward`` expert-parallel MoE forward (unrolled expert slice/add
                   loop + all_reduce vs the dense expert sum)
``tpdp-forward``   tp x dp composite: the 2-D per-rank program vs the 1-D
                   TP program (axis interaction)
``stage``          one pipeline stage in isolation (TP inside the stage)
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs import get_config

from ..plan import Plan, PlanError, Scenario
from .harness import BuildCtx, GraphPair, round_layers
from .registry import DEFAULT_SCENARIOS, ScenarioRegistry, ScenarioSpec

# importing the scenario modules populates DEFAULT_SCENARIOS
from . import composite, dp, ep, pipeline, sp, tp  # noqa: E402,F401


def build_pair(arch: str, plan: Plan, scen: Scenario, stamp: bool = True,
               base_cache: Optional[dict] = None,
               base_key: tuple = ()) -> GraphPair:
    """Build the graph pair for one scenario of a plan via the registry.

    ``base_cache``/``base_key`` are the session's shared base-trace store
    (scenarios of one plan reuse a base trace when program + shapes match).
    """
    spec = DEFAULT_SCENARIOS.get(scen.kind)
    cfg = round_layers(get_arch_config(arch, smoke=plan.smoke), plan.layers,
                       stages=plan.stages)
    ctx = BuildCtx(stamp=stamp, base_cache=base_cache, base_key=base_key)
    return spec.builder(arch, cfg, plan, scen, ctx)


def get_arch_config(arch: str, smoke: bool = False):
    """``repro_torch.configs.get_config``, with an architecture whose family
    is not ported yet reported as a ``PlanError``."""
    try:
        return get_config(arch, smoke=smoke)
    except ModuleNotFoundError:
        raise PlanError(f"{arch}: its family is not ported yet") from None


__all__ = [
    "BuildCtx", "DEFAULT_SCENARIOS", "GraphPair", "ScenarioRegistry",
    "ScenarioSpec", "build_pair", "get_arch_config", "round_layers",
]
