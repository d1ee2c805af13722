"""Nothing the harness runs on the card loads JAX or the JAX package, and no
reference loads the program; top-level names are compared whole, since the
port's ``repro_torch`` begins with the JAX package's ``repro``."""
import json
import subprocess
import sys

import spec

PROBE = """
import json, sys
sys.path[:0] = [{here!r}, {src!r}]
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    code = PROBE.format(here=str(spec.HERE), src=str(spec.ROOT / "src"), imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    loaded = _top_level("import run, prefill, control, check, inputs, tracing\n"
                        "import repro_torch.models\n"
                        "import repro_torch.kernels.ops")
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_references_load_neither_jax_nor_the_program():
    refs = sorted(p.stem for p in (spec.HERE / "reference").glob("*.py")
                  if p.stem != "__init__")
    assert refs
    loaded = _top_level("\n".join(f"import reference.{r}" for r in refs)
                        + "\nimport yardstick, check, inputs")
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_compared_whole():
    import run

    sys.modules.setdefault("repro_torch_probe_module", sys)
    try:
        assert "repro_torch_probe_module" not in run.forbidden_modules()
        sys.modules["repro.probe"] = sys
        assert run.forbidden_modules() == ["repro.probe"]
    finally:
        sys.modules.pop("repro.probe", None)
        sys.modules.pop("repro_torch_probe_module", None)
