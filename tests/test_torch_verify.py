"""The port's verification API and CLI against the JAX package's: verdicts of
llama3_8b and qwen3_4b tp-forward at tp 2 and 4 (full width, 2 layers), the
CLI's exit codes, the warm disk cache, the stamped full-depth trace, and the
llama3_8b tp4 campaign cells.  The per-op histogram of the torch trace
against the JAX trace of the same pair is printed as information."""
import collections
import json

import pytest

pytest.importorskip("torch")

from repro.verify import Plan as JPlan  # noqa: E402
from repro.verify import Session as JSession  # noqa: E402
from repro.verify import cli as jcli  # noqa: E402
from repro.verify.campaign import run_campaign as jrun_campaign  # noqa: E402
from repro.verify.scenarios import build_pair as jbuild_pair  # noqa: E402

from repro_torch.verify import Plan, Session, run_campaign  # noqa: E402
from repro_torch.verify import cli  # noqa: E402
from repro_torch.verify.scenarios import build_pair  # noqa: E402

LAYERS = 2


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["llama3_8b", "qwen3_4b"])
def test_verdict_matches_jax(arch, tp):
    with Session() as s:
        got = s.verify(arch, Plan(tp=tp, layers=LAYERS))
    with JSession() as s:
        want = s.verify(arch, JPlan(tp=tp, layers=LAYERS))
    assert got.verified == want.verified is True
    assert got.outputs_ok == want.outputs_ok
    assert [r["scenario"] for r in got.scenarios] == [r["scenario"] for r in want.scenarios]
    assert not got.stamped  # 2 layers: fewer than TRACE_PERIODS + 1 periods


def test_full_depth_is_stamped():
    with Session() as s:
        rep = s.verify("llama3_8b", Plan(tp=4, layers=8))
    assert rep.verified and rep.stamped
    assert rep.scenarios[0]["stamped"] is True


# (argv, the port's exit code, the reference's; None: not run, since the
# reference supports the scenario the port does not have yet)
@pytest.mark.parametrize("argv,code,jax_code", [
    (["llama3_8b", "--tp", "4", "--layers", "2"], 0, 0),
    (["llama3_8b", "--tp", "4", "--layers", "2", "--inject", "drop_all_reduce"], 1, 1),
    (["llama3_8b", "--tp", "1"], 2, 2),
    (["no_such_arch", "--tp", "4"], 2, 2),
    (["llama3_8b", "--tp", "4", "--decode"], 2, None),
    (["llama3_8b", "--tp", "4", "--sp"], 2, None),
])
def test_cli_exit_codes_match_jax(argv, code, jax_code, capsys):
    assert cli.main(argv + ["--quiet"]) == code
    if jax_code is not None:
        assert jcli.main(argv + ["--quiet"]) == jax_code


def test_cli_unported_and_lint_exit_2(capsys):
    assert cli.main(["mixtral_8x7b", "--tp", "4"]) == 2
    assert cli.main(["llama3_8b", "--tp", "4", "--lint"]) == 2
    assert cli.main(["lint", "--arch", "llama3_8b"]) == 2
    err = capsys.readouterr().err
    assert "not ported" in err
    with pytest.raises(NotImplementedError):
        Session().verify("llama3_8b", Plan(tp=4, layers=LAYERS), lint=True)
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "tp-forward" in out and "llama3_8b" in out and "tp-decode" not in out


def test_warm_disk_cache_gives_the_same_canonical_report(tmp_path, capsys):
    argv = ["llama3_8b", "--tp", "4", "--layers", "2", "--cache-dir", str(tmp_path),
            "--json", "-", "--quiet"]
    assert cli.main(argv) == 0
    cold = json.loads(capsys.readouterr().out)
    assert cli.main(argv) == 0
    warm = json.loads(capsys.readouterr().out)
    assert not cold["cache"]["disk_warm"] and warm["cache"]["disk_warm"]
    with Session(cache_dir=str(tmp_path)) as s:
        rep_warm = s.verify("llama3_8b", Plan(tp=4, layers=2))
    with Session() as s:
        rep_cold = s.verify("llama3_8b", Plan(tp=4, layers=2))
    assert rep_warm.cache.disk_warm
    assert json.dumps(rep_warm.canonical(), sort_keys=True) == json.dumps(
        rep_cold.canonical(), sort_keys=True)


def test_campaign_cells_match_jax():
    got = run_campaign(["llama3_8b"], tp=4, scenarios=["tp-forward"])
    want = jrun_campaign(["llama3_8b"], tp=4, scenarios=["tp-forward"])
    cells = {c.injector: (c.outcome, c.localized) for c in got.cells}
    assert cells == {c.injector: (c.outcome, c.localized) for c in want.cells}
    assert got.ok and got.detected == 9 and got.missed == 0
    assert got.false_positives == 0 and got.localization_rate == 1.0
    assert {c.injector for c in got.cells if c.outcome == "skipped"} == {
        "wrong_all_gather_dim", "wrong_scatter_dim"}
    assert "lint tier: not ported" in got.summary()


def test_unported_campaign_scenarios_are_not_missed():
    rep = run_campaign(["llama3_8b"], tp=4, scenarios=["tp-forward", "tp-decode"],
                       injectors=["drop_all_reduce"])
    decode = [c for c in rep.cells if c.scenario == "tp-decode"]
    assert decode and {c.outcome for c in decode} == {"not_ported"}
    assert rep.ok and rep.missed == 0 and rep.detected == 1
    assert cli.campaign_main(["--fuzz-only", "--seeds", "2", "--quiet"]) == 0


def test_op_histogram_against_jax():
    """Information only: which IR ops each tracer emits for one pair."""
    plan, jplan = Plan(tp=4, layers=LAYERS), JPlan(tp=4, layers=LAYERS)
    got = build_pair("llama3_8b", plan, plan.scenarios()[0], stamp=False)
    want = jbuild_pair("llama3_8b", jplan, jplan.scenarios()[0], stamp=False)
    for side in ("base", "dist"):
        t = collections.Counter(n.op for n in getattr(got, side))
        j = collections.Counter(n.op for n in getattr(want, side))
        print(f"\n{side}: torch {sum(t.values())} nodes, jax {sum(j.values())} nodes")
        for op in sorted(set(t) | set(j), key=lambda o: -(t[o] + j[o])):
            print(f"  {op:14s} torch {t[op]:4d}  jax {j[op]:4d}")
    assert got.dist_inputs and len(got.dist_inputs) == len(want.dist_inputs)
