"""repro_torch.verify — the port's verification API (the JAX package's
``repro.verify``, over graphs traced from the torch models):

    from repro_torch.verify import Session, Plan

    with Session() as s:
        report = s.verify("llama3_8b", Plan(tp=4))       # TP forward

    assert report.verified, report.summary()
    print(report.to_json())

The :class:`Session` owns cross-call state (trace + template caches, a
persistent worker pool), so sweeps and re-verifies are warm-start.
One-shots: :func:`verify`.  CLI: ``python -m repro_torch.verify <arch>
--tp 4 [--decode | --sp]``.  The ``tp-forward``, ``tp-decode`` and
``sp-forward`` scenarios are ported so far (``python -m repro_torch.verify
--list``).
"""
from repro_torch.core.inject import DEFAULT_INJECTORS, InjectorRegistry, InjectorSpec
from repro_torch.core.report import (
    BugSite,
    CacheStats,
    PhaseTimings,
    Report,
    severity_of,
)
from repro_torch.core.verifier import VerifyOptions

from .campaign import CampaignReport, run_campaign
from .plan import Plan, PlanError, Scenario
from .scenarios import DEFAULT_SCENARIOS, ScenarioRegistry, ScenarioSpec
from .session import Session, verify
from .specs import shard_dim, spec_input_facts, spec_output_specs

__all__ = [
    "BugSite", "CacheStats", "PhaseTimings", "Report", "severity_of",
    "VerifyOptions",
    "Plan", "PlanError", "Scenario",
    "DEFAULT_SCENARIOS", "ScenarioRegistry", "ScenarioSpec",
    "DEFAULT_INJECTORS", "InjectorRegistry", "InjectorSpec",
    "CampaignReport", "run_campaign",
    "Session", "verify",
    "shard_dim", "spec_input_facts", "spec_output_specs",
]
