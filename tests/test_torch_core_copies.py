"""The port's verifier is the JAX package's verifier over the same IR: every
module that imports no JAX is a copy, equal to its counterpart's text once
the import lines are normalized (``repro.`` -> ``repro_torch.``).  The
modules that had to be rewritten for torch are named here as the known
exceptions, each with its reason."""
import re
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

COPIES = [
    *(f"core/{m}.py" for m in (
        "ir", "relations", "bijection", "egraph", "partition", "stamp", "report",
        "inject", "synth")),
    *(f"core/rules/{m}.py" for m in (
        "__init__", "collective", "common", "congruence", "dot", "elementwise",
        "engine", "fusion", "layout", "legacy", "parshard", "propagator", "reduce",
        "registry", "sliceops")),
    "verify/plan.py", "verify/specs.py", "verify/scenarios/registry.py",
    "verify/scenarios/sp.py", "train/straggler.py",
    *(f"analysis/{m}.py" for m in (
        "__init__", "report", "registry", "placement", "lints", "rulecheck")),
    *(f"configs/{a}.py" for a in (
        "llama3_8b", "qwen3_4b", "mamba2_130m", "qwen1_5_4b", "chatglm3_6b", "gemma_2b",
        "llama3_70b", "llama3_405b", "hubert_xlarge", "internvl2_26b",
        "granite_moe_3b", "moonshot_v1_16b", "mixtral_8x7b", "mixtral_8x22b",
        "jamba_1_5_large")),
]

# rewritten for torch, not copies
KNOWN_EXCEPTIONS = {
    "core/trace.py": "make_fx over fake tensors in place of make_jaxpr",
    "core/verifier.py": "verify_sharded traces torch functions; no AbstractMesh",
    "core/rules/meta.py": "the vp_embed template is traced by the port's tracer",
    "core/__init__.py": "exports the port's tracer",
    "verify/scenarios/harness.py": "shapes are ShapeDtype / fake tensors",
    "verify/scenarios/tp.py": "the rank is a traced input; decode traced functionalized",
    "verify/store.py": "the rules hash keys on the torch version",
    "verify/session.py": "configs through get_arch_config; reports carry stamped",
    "verify/cli.py": "lists the ported archs; the port's verbs and help",
    "verify/scenarios/__init__.py": "an arch whose family is not ported is a PlanError",
    "verify/scenarios/dp.py": "dp-grad traced through torch.autograd, its rank program "
                              "spmd.dp_grad; torch pytrees",
    "verify/scenarios/ep.py": "the rank is a traced input; no AbstractMesh",
    "verify/campaign.py": "configs through get_arch_config",
    "verify/scenarios/pipeline.py": "the rank is a traced input; the stage program "
                                    "is shared with parallel/pipeline.py",
    "verify/scenarios/composite.py": "the 2-D mesh is traced under the fake process "
                                     "group, one subgroup an axis",
    "parallel/ctx.py": "functional collectives on one process group an axis",
    "parallel/pipeline.py": "a Python loop of ticks and an all_to_all ring in place "
                            "of lax.scan and ppermute",
    "launch/mesh.py": "a DeviceMesh over the running process group",
    "launch/analysis.py": "the H100 model; counts from the port's count-mode trace, "
                          "no XLA cost or memory analysis",
    "launch/dryrun.py": "cells traced under a fake process group over the mesh; "
                        "memory from MemTracker under FakeTensorMode",
    "analysis/single.py": "traces through the port's tracer, the rank a traced "
                          "input under the fake process group",
}

_IMPORT = re.compile(r"^(\s*)(from|import)\s+repro(_torch)?\.", re.M)


def _normalized(path: Path) -> str:
    return _IMPORT.sub(lambda m: f"{m[1]}{m[2]} PKG.", path.read_text())


@pytest.mark.parametrize("module", COPIES)
def test_copy_matches_reference(module):
    ref, port = SRC / "repro" / module, SRC / "repro_torch" / module
    assert port.exists(), f"{module} is missing from the port"
    assert _normalized(port) == _normalized(ref), (
        f"repro_torch/{module} drifted from repro/{module}; port the change to "
        "both or list the module as a known exception")


@pytest.mark.parametrize("module", sorted(KNOWN_EXCEPTIONS))
def test_known_exceptions_exist_and_differ(module):
    ref, port = SRC / "repro" / module, SRC / "repro_torch" / module
    assert ref.exists() and port.exists()
    assert _normalized(port) != _normalized(ref)
    assert "import jax" not in port.read_text()
