"""The detection campaign on the MoE archs, cell for cell with the JAX
package's: granite_moe_3b and mixtral_8x7b at ``--tp 4 --layers 2`` over
tp-forward, tp-decode, sp-forward and ep-moe-forward give 76 detected
cells, none missed, no false positive, and the reference's four detected
cells that neither package localizes (``drop_all_reduce`` in sp-forward and
in ep-moe-forward, for both archs).  A file of its own, so the campaign
runs on one worker beside the other verify files."""
import pytest

pytest.importorskip("torch")

from repro.verify.campaign import run_campaign as jrun_campaign  # noqa: E402

from repro_torch.verify import cli, run_campaign  # noqa: E402

ARCHS = ["granite_moe_3b", "mixtral_8x7b"]


@pytest.fixture(scope="module")
def campaigns():
    return run_campaign(ARCHS, tp=4, layers=2), jrun_campaign(ARCHS, tp=4, layers=2)


def test_moe_campaign_cells_match_jax(campaigns):
    got, want = campaigns
    key = lambda c: (c.arch, c.scenario, c.injector)  # noqa: E731
    cells = {key(c): (c.outcome, c.localized) for c in got.cells}
    assert cells == {key(c): (c.outcome, c.localized) for c in want.cells}
    assert {c.scenario for c in got.cells} == {"tp-forward", "tp-decode", "sp-forward",
                                               "ep-moe-forward"}
    assert "not_ported" not in {o for o, _ in cells.values()}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_campaign_counts(campaigns, arch):
    got, _ = campaigns
    cells = [c for c in got.cells if c.arch == arch]
    assert sum(c.outcome in ("detected", "mislocalized") for c in cells) == 38
    assert not any(c.outcome in ("missed", "false_positive") for c in cells)
    assert {(c.scenario, c.injector) for c in cells if c.outcome == "mislocalized"} == {
        ("sp-forward", "drop_all_reduce"), ("ep-moe-forward", "drop_all_reduce")}
    assert got.ok and got.detected == 76 and got.missed == 0 and got.false_positives == 0


def test_moe_campaign_cli_exits_0(capsys):
    assert cli.campaign_main(["--arch", "mixtral_8x7b", "--tp", "4", "--layers", "2",
                              "--scenarios", "ep-moe-forward", "--quiet"]) == 0
