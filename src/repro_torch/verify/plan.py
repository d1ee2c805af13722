"""Declarative parallelism plans — *what* to verify, not *how*.

A :class:`Plan` names the parallelization strategy a deployment intends to
run as **composable axis specs** (``Plan(tp=16)``, ``Plan(tp=8, sp=True)``,
``Plan(ep=4)``, ``Plan(tp=4, dp=2, composite=True)``, ``Plan.decode(tp=16)``,
``Plan.grad(dp=8)``, ``Plan.pipeline(stages=4)``) and expands into the
per-axis :class:`Scenario` list the :class:`~repro.verify.session.Session`
executes — the paper's per-technique verification: multi-axis meshes are
verified one axis at a time (plus the composite scenario checking the
tp x dp axis *interaction* against the 1D TP program).

Scenario kinds are resolved by the scenario registry
(:mod:`repro.verify.scenarios`); ``python -m repro.verify --list``
enumerates them:

``tp-forward``      baseline forward vs TP/EP-sharded per-device forward
``tp-decode``       one serving step against head-sharded KV/SSM caches
``sp-forward``      sequence-parallel forward (reduce_scatter/all_gather
                    instead of psum around the norm regions)
``ep-moe-forward``  expert-parallel MoE forward (unrolled expert slice
                    loop + all_reduce vs the dense expert sum)
``dp-forward``      batch-sharded forward (catches cross-batch interaction)
``dp-grad``         per-device sum-loss gradients + psum vs full-batch
                    grads (the DP gradient-sync contract)
``tpdp-forward``    tp x dp composite: the 2D per-device program vs the 1D
                    TP program (axis interaction)
``stage[i/n]``      pipeline stage i verified in isolation (TP within the
                    stage; ppermute boundary transfers are identity hops
                    checked numerically in tests/test_pipeline.py)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

MODES = ("forward", "decode", "grad", "pipeline")

# mesh axis names per scenario family (launch/mesh.py roles)
TP_AXIS = "model"
DP_AXIS = "data"


class PlanError(ValueError):
    """Invalid plan declaration (CLI maps this to exit code 2)."""


@dataclass(frozen=True)
class Scenario:
    """One per-axis verification unit of a plan."""

    kind: str  # a kind registered in repro.verify.scenarios
    axis: str  # mesh axis verified
    size: int  # device count along that axis
    stage: int = -1  # pipeline scenarios: stage index

    @property
    def name(self) -> str:
        return self.kind if self.stage < 0 else f"{self.kind}{self.stage}"


@dataclass(frozen=True)
class Plan:
    """Declarative parallelism plan over composable axes.

    ``tp``/``dp``/``ep`` are the tensor-/data-/expert-parallel degrees;
    ``sp`` turns the TP forward into its sequence-parallel formulation;
    ``composite`` adds the tp x dp interaction scenario.  ``mode`` selects
    the traced program for the non-forward families (``decode`` | ``grad``
    | ``pipeline``); ``stages`` the pipeline stage count.  Shape knobs
    (``layers``/``batch``/``seq``/``max_len``/``smoke``) bound the traced
    workload — ``layers`` rounds up to a whole block period; ``batch=None``
    picks a per-scenario default (1 for TP/SP/EP forward, ``2*dp`` for DP
    scenarios, 2 for decode).
    """

    tp: int = 1
    dp: int = 1
    ep: int = 1
    sp: bool = False
    composite: bool = False
    mode: str = "forward"
    stages: int = 1
    layers: Optional[int] = None
    batch: Optional[int] = None
    seq: int = 32
    max_len: int = 64
    smoke: bool = False

    # -- constructors -------------------------------------------------------
    @classmethod
    def decode(cls, tp: int = 16, **kw) -> "Plan":
        """Verify the serving step (one token vs sharded KV/SSM caches)."""
        return cls(tp=tp, mode="decode", **kw)

    @classmethod
    def grad(cls, dp: int = 8, **kw) -> "Plan":
        """Verify the data-parallel gradient-sync contract."""
        return cls(dp=dp, mode="grad", **kw)

    @classmethod
    def pipeline(cls, stages: int = 4, tp: int = 2, **kw) -> "Plan":
        """Verify each pipeline stage's TP parallelization in isolation."""
        return cls(tp=tp, stages=stages, mode="pipeline", **kw)

    @classmethod
    def moe(cls, ep: int = 4, **kw) -> "Plan":
        """Verify the expert-parallel MoE forward (expert axis)."""
        return cls(ep=ep, **kw)

    # -- validation ---------------------------------------------------------
    def __post_init__(self) -> None:
        for name in ("tp", "dp", "ep", "stages"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise PlanError(f"{name} must be a positive int, got {v!r}")
        if self.mode not in MODES:
            raise PlanError(f"unknown mode {self.mode!r}: one of {MODES}")
        if self.sp:
            if self.mode != "forward":
                raise PlanError("sp composes with forward plans only "
                                "(sequence-parallel decode is not modeled)")
            if self.tp == 1:
                raise PlanError("sp shards activations over the tp axis: "
                                "need tp > 1")
        if self.ep > 1 and self.mode != "forward":
            raise PlanError("ep composes with forward plans only")
        if self.composite:
            if self.mode != "forward" or self.tp == 1 or self.dp == 1:
                raise PlanError("composite declares the tp x dp interaction "
                                "scenario: need mode='forward', tp > 1 and "
                                "dp > 1")
            if self.sp:
                raise PlanError(
                    "composite verifies the plain-TP 2D program; its chain "
                    "argument needs the tp-forward scenario, which sp=True "
                    "replaces — declare them as two Plans")
        if (self.mode == "forward" and self.tp == 1 and self.dp == 1
                and self.ep == 1):
            raise PlanError("Plan(tp=1, dp=1, ep=1) declares no parallelism: "
                            "nothing to verify")
        if self.mode == "decode":
            if self.tp == 1:
                raise PlanError("decode plans verify the tp axis: need tp > 1")
            if self.dp > 1:
                raise PlanError("decode plans verify the tp axis only "
                                "(batched serving DP is replication)")
        if self.mode == "grad":
            if self.dp == 1:
                raise PlanError("grad plans verify the dp axis: need dp > 1")
            if self.tp > 1:
                raise PlanError("grad plans verify the dp axis only; verify "
                                "the tp axis with a separate Plan(tp=...)")
        if self.mode == "pipeline":
            if self.stages < 2:
                raise PlanError("pipeline plans need stages >= 2")
            if self.tp < 2:
                raise PlanError("pipeline plans verify per-stage TP: need tp >= 2")
            if self.dp > 1:
                raise PlanError("pipeline plans verify the stage/tp axes only")
        if self.mode != "pipeline" and self.stages > 1:
            raise PlanError("stages > 1 requires mode='pipeline' "
                            "(use Plan.pipeline(stages=...))")
        if self.batch is not None and self.batch < 1:
            raise PlanError(f"batch must be positive, got {self.batch!r}")
        for s in self.dp_scenario_sizes():
            b = self.batch if self.batch is not None else 2 * s
            if b % s:
                raise PlanError(
                    f"batch={b} not divisible by dp={s} (batch sharding)")

    def dp_scenario_sizes(self) -> list[int]:
        return [self.dp] if self.dp > 1 else []

    # -- expansion ----------------------------------------------------------
    def scenarios(self) -> tuple[Scenario, ...]:
        if self.mode == "decode":
            return (Scenario("tp-decode", TP_AXIS, self.tp),)
        if self.mode == "grad":
            return (Scenario("dp-grad", DP_AXIS, self.dp),)
        if self.mode == "pipeline":
            return tuple(
                Scenario("stage", TP_AXIS, self.tp, stage=i)
                for i in range(self.stages)
            )
        out = []
        if self.tp > 1:
            out.append(Scenario("sp-forward" if self.sp else "tp-forward",
                                TP_AXIS, self.tp))
        if self.ep > 1:
            out.append(Scenario("ep-moe-forward", TP_AXIS, self.ep))
        if self.dp > 1:
            # the composite subsumes the per-axis dp-forward: single-device
            # == TP (tp-forward) and TP == tp x dp (tpdp-forward) compose
            out.append(Scenario("tpdp-forward" if self.composite
                                else "dp-forward", DP_AXIS, self.dp))
        return tuple(out)

    def scenario_batch(self, scen: Scenario) -> int:
        if self.batch is not None:
            return self.batch
        if scen.axis == DP_AXIS:
            return 2 * scen.size
        return 2 if scen.kind == "tp-decode" else 1

    # -- identity -----------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "tp": self.tp, "dp": self.dp, "ep": self.ep, "sp": self.sp,
            "composite": self.composite, "mode": self.mode,
            "stages": self.stages, "layers": self.layers, "batch": self.batch,
            "seq": self.seq, "max_len": self.max_len, "smoke": self.smoke,
        }

    def describe(self) -> str:
        parts = [f"tp{self.tp}"] if self.tp > 1 else []
        if self.sp:
            parts.append("sp")
        if self.ep > 1:
            parts.append(f"ep{self.ep}")
        if self.dp > 1:
            parts.append(f"dp{self.dp}x" if self.composite else f"dp{self.dp}")
        if self.stages > 1:
            parts.append(f"pp{self.stages}")
        return f"{'+'.join(parts) or 'single'}-{self.mode}"
