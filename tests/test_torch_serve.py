"""The port's serving path on the CPU: greedy generations equal the JAX
engine's for the same f32 SMOKE weights, the launcher runs with
``--device cpu`` and its ``--verify-tp`` pre-flight gives the JAX
launcher's exit codes, and the port imports neither jax nor the JAX
package.

For mamba2_130m the JAX engine's generations depend on the batch: an SSM
slot absorbs the pad token 0 at every step in which it is not fed, and its
state is not reset when a new request takes the slot.  The port keeps that
behaviour, and the engine test pins it."""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROMPT_LENS = [3, 7, 5, 2]


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).tolist() for n in PROMPT_LENS]


def _serve(engine, prompts, max_new):
    ids = [engine.submit(p, max_new=max_new) for p in prompts]
    out = engine.run()
    return [out[i] for i in ids]


@pytest.mark.parametrize("arch", ["qwen3_4b", "llama3_8b", "mamba2_130m", "qwen1_5_4b",
                                  "chatglm3_6b"])
def test_engine_greedy_matches_jax(arch):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    jm = JaxModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    prompts = _prompts()
    want = _serve(JaxEngine(jm, jp, JaxServeConfig(max_len=32, batch_slots=2)), prompts, 6)
    got = _serve(Engine(Model(tcfg, device="cpu"), tp,
                        ServeConfig(max_len=32, batch_slots=2)), prompts, 6)
    assert got == want
    assert all(len(g) == 6 for g in got)


def test_engine_sampling_is_seeded():
    cfg = get_config("qwen3_4b", smoke=True)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    runs = [_serve(Engine(model, params, ServeConfig(max_len=32, batch_slots=2,
                                                     temperature=1.0, seed=5)),
                   _prompts(), 4) for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(0 <= t < cfg.vocab for g in runs[0] for t in g)


def test_launcher_serves_on_cpu(capsys):
    assert launch_serve.main(["--device", "cpu", "--requests", "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert out.count("[done] req") == 3 and "on cpu" in out


def test_launcher_serves_mamba_on_cpu(capsys):
    assert launch_serve.main(["--arch", "mamba2_130m", "--device", "cpu",
                              "--requests", "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert out.count("[done] req") == 3 and "on cpu" in out


# (arch, --verify-tp, exit code of both launchers): qwen3_4b's SMOKE config
# has 2 KV heads, so a 4-way decode plan is invalid in both packages;
# mamba2_130m's SMOKE config with one SSD head a rank verifies in neither
@pytest.mark.parametrize("arch,tp,code", [
    ("qwen3_4b", 2, 0), ("qwen3_4b", 4, 2), ("mamba2_130m", 2, 0), ("mamba2_130m", 4, 2)])
def test_launcher_verify_tp_matches_jax(arch, tp, code, capsys):
    from repro.launch import serve as jax_serve

    argv = ["--arch", arch, "--verify-tp", str(tp), "--requests", "2", "--max-new", "3"]
    assert launch_serve.main(argv + ["--device", "cpu"]) == code
    out = capsys.readouterr().out
    assert f"[verify] checking {arch} plan tp{tp}-decode" in out
    if code == 0:
        assert "[verify] VERIFIED" in out and out.count("[done] req") == 2
    else:
        assert "[verify] ABORTING" in out and "[done]" not in out
    assert jax_serve.main(argv) == code


def test_launcher_unverified_plan_exits_before_serving(monkeypatch, capsys):
    """A decode step whose attention output skips its psum does not verify:
    the launcher exits 2 before any weight is drawn."""
    from repro_torch.models import attention

    real = attention.attn_decode

    def no_psum(cfg, ctx, *a, **kw):
        return real(cfg, dataclasses.replace(ctx, tp_axis=None), *a, **kw)

    monkeypatch.setattr(attention, "attn_decode", no_psum)
    monkeypatch.setattr("repro_torch.models.model.attn_decode", no_psum)
    monkeypatch.setattr(launch_serve, "Model", lambda *a, **kw: pytest.fail("model built"))
    argv = ["--arch", "qwen3_4b", "--verify-tp", "2", "--device", "cpu"]
    assert launch_serve.main(argv) == 2
    out = capsys.readouterr().out
    assert "[verify] UNVERIFIED" in out and "ABORTING" in out and "[done]" not in out


def test_launcher_needs_gpu_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--requests", "1"])


_ISOLATED = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now fails
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from repro_torch.verify.cli import main
assert main(["--list"]) == 0  # the verify CLI, with its scenario registry
assert main(["llama3_8b", "--tp", "2", "--smoke", "--quiet"]) == 0
bad = [m for m in sys.modules if m == "repro" or m.startswith(("repro.", "triton"))]
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax():
    code = _ISOLATED.format(src=str(ROOT / "src"), root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 60  # incl. core/, core/rules/, verify/


# msgpack and zstandard, which the JAX package's checkpoints use, are absent
# on the card's machine
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$|,)|from\s+repro[\s.]"
    r"|(import|from)\s+(msgpack|zstandard)\b)")


def test_port_sources_name_no_jax_or_repro_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 16
    hits = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
            for f in files for i, line in enumerate(f.read_text().splitlines(), 1)
            if _FORBIDDEN.match(line)]
    assert not hits, hits
