"""The port's verifier on the MoE archs against the JAX package's.  TP
scenarios trace the dense-masked formulation (``moe_dense_fwd``: the expert
stacks sharded over their FFN width, one all_reduce for the experts and one
for the shared expert); ``ep-moe-forward`` traces ``moe_ep_fwd`` (the
stacks sharded over the experts, each rank its slice of the dense routing
mask at ``axis_index * E_loc`` and an unrolled slice/add chain, one
all_reduce).  The same verdicts, memo hits and live-node op histograms as
the reference at axis size 2 and 4, up to ``EMBED_DIFF`` (the expert-
parallel program embeds on one device, as dp-forward's does) and one
``convert`` a layer with padded experts (granite's router masks them with
``where(mask, -1e30, logits)``, whose Python scalar jnp converts from a
weak type; the same difference as ``_segsum``'s -inf).  JAX keeps that
weakly typed scalar as a float64 constant of its own, where the port's
float32 constant is the one the attention mask's -1e30 (``_segsum``'s
-inf: the router softmax's -inf floor) already put in the graph: one
``const`` fewer in the port for each of the two.  jamba_1_5_large
runs at SMOKE size: its block period of 8 layers is whole at ``--layers
2`` and full width.  A MoE arch's DP plan is the reference's
``PlanError``."""
import pytest

pytest.importorskip("torch")

from repro.verify import Plan as JPlan  # noqa: E402
from repro.verify import Session as JSession  # noqa: E402
from repro.verify import cli as jcli  # noqa: E402
from repro.verify.plan import PlanError as JPlanError  # noqa: E402
from repro.verify.scenarios import build_pair as jbuild_pair  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.verify import Plan, Session  # noqa: E402
from repro_torch.verify import cli  # noqa: E402
from repro_torch.verify.plan import PlanError  # noqa: E402
from repro_torch.verify.scenarios import build_pair  # noqa: E402
from test_torch_verify import EMBED_DIFF, LAYERS, _live_ops  # noqa: E402

SCENARIOS = {"tp-forward": {}, "tp-decode": {"mode": "decode"}, "sp-forward": {"sp": True},
             "ep-moe-forward": {}}
# jamba's SMOKE config has 2 KV heads and 4 experts: axis size 2 only
CASES = [(a, s, n) for a in ("granite_moe_3b", "moonshot_v1_16b", "mixtral_8x7b")
         for s in SCENARIOS for n in (2, 4)] + [
    ("jamba_1_5_large", "tp-forward", 2), ("jamba_1_5_large", "ep-moe-forward", 2)]


def _plans(scenario: str, size: int, smoke: bool):
    axis = {"ep": size} if scenario == "ep-moe-forward" else {"tp": size}
    kw = dict(axis, **SCENARIOS[scenario], smoke=smoke,
              layers=None if smoke else LAYERS)
    return Plan(**kw), JPlan(**kw)


def _want_diff(arch: str, scenario: str, side: str, smoke: bool) -> dict:
    cfg = get_config(arch, smoke=smoke)
    layers = cfg.n_layers if smoke else LAYERS
    embed = EMBED_DIFF["base" if scenario == "ep-moe-forward" else side]
    padded = sum(cfg.is_moe_layer(i) for i in range(layers)) if (
        cfg.n_experts_padded > cfg.n_experts) else 0
    segsum = 0 if scenario == "tp-decode" else sum(
        not cfg.is_attn_layer(i) for i in range(layers))
    convert = embed.get("convert", 0) - padded - segsum
    const = embed.get("const", 0) - bool(padded) - bool(segsum)
    return dict(embed, **({"convert": convert} if convert else {}),
                **({"const": const} if const else {}))


@pytest.fixture(scope="module")
def sessions():
    with Session() as s, JSession() as js:
        yield s, js


@pytest.mark.parametrize("arch,scenario,size", CASES)
def test_moe_verdict_matches_jax(arch, scenario, size, sessions):
    s, js = sessions
    smoke = arch == "jamba_1_5_large"
    plan, jplan = _plans(scenario, size, smoke)
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
        assert diff == _want_diff(arch, scenario, side, smoke), (side, diff)


def test_single_expert_ranks_give_the_reference_verdict():
    """jamba's SMOKE config at ep 4 leaves one expert a rank: the
    reference does not verify it (its accumulation has no add left to
    relate), and neither does the port."""
    plan, jplan = _plans("ep-moe-forward", 4, smoke=True)
    got = Session().verify("jamba_1_5_large", plan)
    want = JSession().verify("jamba_1_5_large", jplan)
    assert got.verified is want.verified is False


def test_moe_dp_plan_and_dense_ep_plan_are_invalid(capsys):
    """DP plans skip MoE archs in both packages (the dense mask scatters
    against local token ids); ep-moe-forward needs experts, divisible by
    the axis."""
    for arch, axis in (("granite_moe_3b", {"dp": 2}), ("llama3_8b", {"ep": 4})):
        with pytest.raises(PlanError) as err:
            Session().verify(arch, Plan(**axis, layers=LAYERS))
        with pytest.raises(JPlanError) as jerr:
            JSession().verify(arch, JPlan(**axis, layers=LAYERS))
        assert str(err.value) == str(jerr.value)
    with pytest.raises(PlanError, match="not divisible by ep=32"):
        Session().verify("granite_moe_3b", Plan(ep=32, layers=LAYERS))
    for argv, code in ((["granite_moe_3b", "--dp", "2", "--layers", "2"], 2),
                       (["mixtral_8x7b", "--ep", "4", "--layers", "2"], 0),
                       (["mixtral_8x7b", "--ep", "4", "--layers", "2", "--inject",
                         "wrong_collective_op"], 1)):
        assert cli.main(argv + ["--quiet"]) == code
        assert jcli.main(argv + ["--quiet"]) == code
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "ep-moe-forward" in out and "granite_moe_3b" in out and "mixtral_8x22b" in out
