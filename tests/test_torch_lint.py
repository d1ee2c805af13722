"""The port's lint tier against the JAX package's: clean zoo graphs are
finding-free at tp 1 and 4 and under SP, every registered injector is
flagged (or not) as the reference flags it, with the same findings up to
each package's own source lines, and the ``lint`` verb, ``--lint`` and
``Session(lint=True)`` follow the reference's contract.  (The campaign's
``lint_detected`` column is held to the reference's cell for cell in
``test_torch_verify.py``'s campaign tests, which run those campaigns.)"""
import json

import pytest

pytest.importorskip("torch")

from repro.analysis import run_lints as jrun_lints  # noqa: E402
from repro.analysis import trace_lint_unit as jtrace_lint_unit  # noqa: E402
from repro.analysis import unit_context as junit_context  # noqa: E402
from repro.core.inject import DEFAULT_INJECTORS as JINJECTORS  # noqa: E402

from repro_torch.analysis import (DEFAULT_LINTS, LintError, LintReport,  # noqa: E402
                                  run_lints, trace_lint_unit, unit_context)
from repro_torch.core.inject import DEFAULT_INJECTORS  # noqa: E402
from repro_torch.verify import Plan, Session  # noqa: E402
from repro_torch.verify.cli import main as cli_main  # noqa: E402

DENSE = ["llama3_8b", "qwen3_4b", "mamba2_130m", "qwen1_5_4b", "chatglm3_6b", "gemma_2b"]
UNITS = {}


def _unit(arch, tp=4, sp=False, jax=False):
    key = (arch, tp, sp, jax)
    if key not in UNITS:
        tl = jtrace_lint_unit if jax else trace_lint_unit
        UNITS[key] = tl(arch, tp, sp=sp, layers=2)
    return UNITS[key]


def _mutate(spec):
    def mutate(g):
        inj = spec(g, index=1) or spec(g)  # the CLI's convention
        return g if inj is None else inj.graph
    return mutate


def _findings(rep):
    return sorted((f.pass_name, f.category, f.severity, f.op) for f in rep.findings)


@pytest.mark.parametrize("tp,sp", [(1, False), (4, False), (4, True)])
@pytest.mark.parametrize("arch", DENSE)
def test_clean_arch_is_finding_free(arch, tp, sp):
    rep = run_lints(unit_context(_unit(arch, tp, sp)))
    assert rep.ok and rep.errors == 0 and rep.warnings == 0, rep.summary()
    assert len(rep.passes) == len(DEFAULT_LINTS.resolve())


@pytest.mark.parametrize("injector", DEFAULT_INJECTORS.names())
@pytest.mark.parametrize("arch", ["llama3_8b", "gemma_2b"])
def test_injector_findings_match_jax(arch, injector):
    got = run_lints(unit_context(_unit(arch).mutate(_mutate(DEFAULT_INJECTORS.get(injector)))))
    want = jrun_lints(junit_context(
        _unit(arch, jax=True).mutate(_mutate(JINJECTORS.get(injector)))))
    assert got.ok == want.ok
    assert _findings(got) == _findings(want), (got.summary(), want.summary())
    for f in got.findings:  # localized in the port's own code
        assert f.node >= 0 and ".py:" in f.src and "repro/" not in f.src


def test_unknown_pass_raises_and_subsets_run():
    ctx = unit_context(_unit("gemma_2b", 1))
    with pytest.raises(LintError) as ei:
        run_lints(ctx, passes=["no-such-pass"])
    assert "ir-ssa" in str(ei.value) and "partial-leak" in str(ei.value)
    assert sorted(run_lints(ctx, passes=["ir-ssa", "ir-shapes"]).passes) == [
        "ir-shapes", "ir-ssa"]


def test_report_json_round_trip_and_merge():
    bad = run_lints(unit_context(_unit("gemma_2b").mutate(
        _mutate(DEFAULT_INJECTORS.get("drop_all_reduce")))))
    back = LintReport.from_json(bad.to_json())
    assert (back.errors, back.ok) == (bad.errors, bad.ok) and not back.ok
    assert [f.category for f in back.findings] == [f.category for f in bad.findings]
    with pytest.raises(ValueError):
        LintReport.from_json(json.dumps({"schema": 99}))
    clean = run_lints(unit_context(_unit("gemma_2b", 1)))
    merged = LintReport().merge(clean).merge(bad)
    assert len(merged.units) == len(clean.units) + len(bad.units)
    assert merged.errors == bad.errors and not merged.ok


def test_cli_lint_exit_codes(tmp_path, capsys):
    out = tmp_path / "lint.json"
    assert cli_main(["lint", "--arch", "gemma_2b", "--tp", "1", "--tp", "4",
                     "--layers", "2", "--json", str(out)]) == 0
    d = json.loads(out.read_text())
    assert d["ok"] and d["errors"] == 0 and len(d["units"]) == 2
    assert cli_main(["lint", "--arch", "gemma_2b", "--tp", "4", "--layers", "2",
                     "--inject", "drop_all_reduce"]) == 1
    cap = capsys.readouterr()
    assert "missing_all_reduce" in cap.out and "model.py:" in cap.out
    assert cli_main(["lint", "--arch", "nope"]) == 2
    assert cli_main(["lint", "--arch", "gemma_2b", "--passes", "bogus"]) == 2
    assert "ir-ssa" in capsys.readouterr().err
    assert cli_main(["lint", "--arch", "gemma_2b", "--tp", "4", "--inject", "bogus"]) == 2


def test_session_lint_attaches_report():
    """``lint=True`` lints each scenario's distributed graph after the
    injection; the verdict is the relational tier's alone."""
    with Session() as s:
        clean = s.verify("gemma_2b", Plan(tp=4, layers=2), lint=True)
        inj = DEFAULT_INJECTORS.get("drop_all_reduce")
        bad = s.verify("gemma_2b", Plan(tp=4, layers=2), lint=True,
                       mutate_dist=lambda g: inj(g, index=1).graph)
        multi = s.verify("llama3_8b", Plan.pipeline(stages=2, tp=2, layers=4), lint=True)
    assert clean.verified and clean.lint["ok"] and clean.lint["errors"] == 0
    assert not bad.verified and not bad.lint["ok"]
    assert "missing_all_reduce" in {f["category"] for f in bad.lint["findings"]}
    assert multi.verified and multi.lint["ok"] and len(multi.lint["units"]) == 2
