"""The port's verifier on the frontend archs against the JAX package's:
hubert_xlarge (audio frames, an encoder: no decode step) and internvl2_26b
(a projected patch prefix before the tokens; under SP every rank holds the
whole sequence and takes its chunk with a dynamic slice at its rank).  The
same verdicts, memo hits and live-node op histograms as the reference at tp
(dp) 2 and 4, up to ``EMBED_DIFF`` (none for hubert_xlarge, whose frames
take the token embedding's place); the same ``PlanError`` for hubert's
decode plan; and the campaign at ``--tp 4 --dp 2 --layers 2`` cell for
cell, localized flags included: internvl2_26b's sp-forward has four
detected cells that neither package localizes."""
import pytest

pytest.importorskip("torch")

from repro.verify import Plan as JPlan  # noqa: E402
from repro.verify import Session as JSession  # noqa: E402
from repro.verify.campaign import run_campaign as jrun_campaign  # noqa: E402
from repro.verify.plan import PlanError as JPlanError  # noqa: E402
from repro.verify.scenarios import build_pair as jbuild_pair  # noqa: E402

from repro_torch.verify import Plan, Session, run_campaign  # noqa: E402
from repro_torch.verify import cli  # noqa: E402
from repro_torch.verify.plan import PlanError  # noqa: E402
from repro_torch.verify.scenarios import build_pair  # noqa: E402
from test_torch_verify import EMBED_DIFF, LAYERS, _live_ops, _plans  # noqa: E402

CASES = [("hubert_xlarge", s) for s in ("tp-forward", "sp-forward", "dp-forward")] + [
    ("internvl2_26b", s) for s in ("tp-forward", "tp-decode", "sp-forward", "dp-forward")]


@pytest.fixture(scope="module")
def sessions():
    with Session() as s, JSession() as js:
        yield s, js


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch,scenario", CASES)
def test_frontend_verdict_matches_jax(arch, scenario, tp, sessions):
    s, js = sessions
    plan, jplan = _plans(scenario, tp, layers=LAYERS)
    got, want = s.verify(arch, plan), js.verify(arch, jplan)
    assert got.verified == want.verified is True
    assert got.outputs_ok == want.outputs_ok
    assert got.memo.memo_hits == want.memo.memo_hits
    assert [r["scenario"] for r in got.scenarios] == [scenario]
    pair = build_pair(arch, plan, plan.scenarios()[0], stamp=False)
    jpair = jbuild_pair(arch, jplan, jplan.scenarios()[0], stamp=False)
    for side in ("base", "dist"):
        t, j = _live_ops(getattr(pair, side)), _live_ops(getattr(jpair, side))
        diff = {op: t[op] - j[op] for op in t | j if t[op] != j[op]}
        want_diff = ({} if arch == "hubert_xlarge"
                     else EMBED_DIFF["base" if scenario == "dp-forward" else side])
        assert diff == want_diff, (side, diff)


def test_encoder_decode_plan_is_invalid(capsys):
    """hubert_xlarge has no decode step: both packages raise PlanError and
    both CLIs exit 2."""
    with pytest.raises(PlanError, match="encoder-only"):
        Session().verify("hubert_xlarge", Plan.decode(tp=4, layers=LAYERS))
    with pytest.raises(JPlanError, match="encoder-only"):
        JSession().verify("hubert_xlarge", JPlan.decode(tp=4, layers=LAYERS))
    assert cli.main(["hubert_xlarge", "--tp", "4", "--decode", "--quiet"]) == 2
    assert "encoder-only" in capsys.readouterr().err
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "hubert_xlarge" in out and "internvl2_26b" in out


@pytest.mark.parametrize("arch,detected,unlocalized", [
    ("hubert_xlarge", 19, set()),
    ("internvl2_26b", 33, {("sp-forward", i) for i in (
        "drop_all_reduce", "duplicate_all_reduce", "wrong_collective_axis",
        "wrong_replica_groups")}),
])
def test_frontend_campaign_cells_match_jax(arch, detected, unlocalized):
    scenarios = [s for a, s in CASES if a == arch]
    got = run_campaign([arch], tp=4, dp=2, scenarios=scenarios)
    want = jrun_campaign([arch], tp=4, dp=2, scenarios=scenarios)
    cells = {(c.scenario, c.injector): (c.outcome, c.localized) for c in got.cells}
    assert cells == {(c.scenario, c.injector): (c.outcome, c.localized) for c in want.cells}
    assert got.ok and got.detected == detected and got.missed == 0
    assert got.false_positives == 0
    assert {k for k, (o, loc) in cells.items() if o == "mislocalized" and not loc} == unlocalized
