"""The port's verification API and CLI against the JAX package's: verdicts of
llama3_8b, qwen3_4b, mamba2_130m, qwen1_5_4b, chatglm3_6b and gemma_2b for
tp-forward, tp-decode and sp-forward at tp 2 and 4 and dp-forward at dp 2
and 4 (full width, 2 layers), of llama3_70b and llama3_405b's SMOKE configs,
the CLI's exit codes, the warm disk cache, the stamped full-depth trace,
the layer memo hits of the serving step, and the llama3_8b tp4,
mamba2_130m tp4 and gemma_2b tp4/dp2 campaign cells.  Each verdict case
also holds the port's IR to the JAX IR of the same pair op by op, up to the
differences listed at ``EMBED_DIFF``."""
import collections
import json

import pytest

pytest.importorskip("torch")

from repro.verify import Plan as JPlan  # noqa: E402
from repro.verify import Session as JSession  # noqa: E402
from repro.verify import cli as jcli  # noqa: E402
from repro.verify.campaign import run_campaign as jrun_campaign  # noqa: E402
from repro.verify.scenarios import build_pair as jbuild_pair  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.verify import Plan, Session, run_campaign  # noqa: E402
from repro_torch.verify import cli  # noqa: E402
from repro_torch.verify.scenarios import build_pair  # noqa: E402

LAYERS = 2
ARCHS = ["llama3_8b", "qwen3_4b", "mamba2_130m", "qwen1_5_4b", "chatglm3_6b", "gemma_2b"]
SCENARIOS = {"tp-forward": {}, "tp-decode": {"mode": "decode"}, "sp-forward": {"sp": True},
             "dp-forward": {}}


def _plans(scenario: str, size: int, **kw):
    """(port Plan, JAX Plan) of ``scenario`` at axis size ``size``."""
    axis = {"dp": size} if scenario == "dp-forward" else {"tp": size}
    return (Plan(**axis, **SCENARIOS[scenario], **kw),
            JPlan(**axis, **SCENARIOS[scenario], **kw))


# The port's IR against the JAX package's for the same pair, op by op, over
# the nodes the outputs depend on (the JAX tracer keeps dead nodes: the dist
# graph's global-shape inputs, an SSD scan's unused final state).  What stays
# different (ROADMAP queue 3): jnp.take's index wrap inside vp_embed (TP's
# dist); and in a forward, one convert a SSM layer for _segsum's -inf, a
# weakly typed Python scalar in jnp.  The single-device lookup (base, and
# dp-forward's dist) traces as jnp.take does: one filling gather.
EMBED_DIFF = {"base": {},
              "dist": {"lt": -1, "add": -1, "select": -1, "broadcast": -1}}


def _live_ops(g) -> collections.Counter:
    live = set(g.toposort(g.outputs))
    return collections.Counter(n.op for n in g if n.id in live)


@pytest.fixture(scope="module")
def sessions():
    """One session of each package for the verdict cases: the scenarios of
    one arch share its base trace, as they do in a sweep."""
    with Session() as s, JSession() as js:
        yield s, js


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_verdict_matches_jax(arch, tp, scenario, sessions):
    """``tp`` is the scenario's axis size (the data axis for dp-forward)."""
    s, js = sessions
    plan, jplan = _plans(scenario, tp, layers=LAYERS)
    got, want = s.verify(arch, plan), js.verify(arch, jplan)
    assert got.verified == want.verified is True
    assert got.outputs_ok == want.outputs_ok
    assert got.memo.memo_hits == want.memo.memo_hits
    assert [r["scenario"] for r in got.scenarios] == [r["scenario"] for r in want.scenarios]
    assert [r["scenario"] for r in got.scenarios] == [scenario]
    assert not got.stamped  # 2 layers: fewer than TRACE_PERIODS + 1 periods
    pair = build_pair(arch, plan, plan.scenarios()[0], stamp=False)
    jpair = jbuild_pair(arch, jplan, jplan.scenarios()[0], stamp=False)
    cfg = get_config(arch)
    segsum = 0 if scenario == "tp-decode" else sum(
        not cfg.is_attn_layer(i) for i in range(LAYERS))
    for side in ("base", "dist"):
        t, j = _live_ops(getattr(pair, side)), _live_ops(getattr(jpair, side))
        diff = {op: t[op] - j[op] for op in t | j if t[op] != j[op]}
        embed = EMBED_DIFF["base" if scenario == "dp-forward" else side]
        want = dict(embed, **({"convert": -segsum} if segsum else {}))
        assert diff == want, (side, diff)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("arch", ["llama3_70b", "llama3_405b"])
def test_smoke_verdict_matches_jax(arch, scenario, sessions):
    """The paper's L2 and L3 configs at SMOKE size, each scenario at axis
    size 2 (full width and depth at tp 16 run in chip_smoke.py's verify
    phase)."""
    s, js = sessions
    plan, jplan = _plans(scenario, 2, smoke=True)
    got, want = s.verify(arch, plan), js.verify(arch, jplan)
    assert got.verified == want.verified is True
    assert (got.memo.memo_hits, got.outputs_ok) == (want.memo.memo_hits, want.outputs_ok)


def _block_slices(g, layer: int) -> int:
    """Slices of trace inputs taken in ``layer<layer>``'s own scope."""
    return sum(n.scope == f"layer{layer}" and n.op == "slice" and g[n.inputs[0]].op == "input"
               for n in g)


@pytest.mark.parametrize("arch,layers,hits", [("llama3_8b", 2, 1), ("mamba2_130m", 2, 1),
                                              ("gemma_2b", 4, 5)])
def test_decode_memo_hits_match_jax(arch, layers, hits):
    """The serving step's layer partitions are JAX's: each block slices all
    its leaves, its caches' among them, in ``layer<i>`` (functionalize takes
    a cache view again at its first use after an earlier block's write; the
    tracer keeps the program's view), so every block after the first
    replays the first from the memo."""
    plan, jplan = _plans("tp-decode", 4, layers=layers)
    with Session() as s, JSession() as js:
        got, want = s.verify(arch, plan), js.verify(arch, jplan)
    assert got.verified and want.verified
    assert got.memo.memo_hits == want.memo.memo_hits == hits
    g = build_pair(arch, plan, plan.scenarios()[0], stamp=False).base
    jg = jbuild_pair(arch, jplan, jplan.scenarios()[0], stamp=False).base
    for i in range(layers):
        assert _block_slices(g, i) == _block_slices(jg, i) == _block_slices(jg, 0)


def test_full_depth_is_stamped():
    with Session() as s:
        rep = s.verify("llama3_8b", Plan(tp=4, layers=8))
    assert rep.verified and rep.stamped
    assert rep.scenarios[0]["stamped"] is True


# (argv, the port's exit code, the reference's; None: not run, since the
# reference's dp-grad verdict fails on this toolchain's jax, which emits
# ``split`` for RoPE's concatenate, a record that is no parity target)
@pytest.mark.parametrize("argv,code,jax_code", [
    (["llama3_8b", "--tp", "4", "--layers", "2"], 0, 0),
    (["llama3_8b", "--tp", "4", "--layers", "2", "--inject", "drop_all_reduce"], 1, 1),
    (["llama3_8b", "--tp", "1"], 2, 2),
    (["no_such_arch", "--tp", "4"], 2, 2),
    (["llama3_8b", "--dp", "2", "--layers", "2"], 0, 0),
    (["llama3_8b", "--grad", "--dp", "2", "--layers", "2"], 0, None),
    (["llama3_8b", "--pipeline", "2", "--tp", "4", "--layers", "4"], 0, 0),
    (["llama3_8b", "--tp", "4", "--dp", "2", "--composite", "--layers", "2"], 0, 0),
    (["llama3_8b", "--pipeline", "2", "--tp", "1"], 2, 2),
])
def test_cli_exit_codes_match_jax(argv, code, jax_code, capsys):
    assert cli.main(argv + ["--quiet"]) == code
    if jax_code is not None:
        assert jcli.main(argv + ["--quiet"]) == jax_code


def test_cli_unported_and_lint_exit_2(capsys):
    """Nothing is left unported: ``--grad`` and the lint tier run (``--lint``,
    the ``lint`` verb, ``Session(lint=True)``); exit 2 stays for a usage
    error only (``lint`` without an arch)."""
    assert cli.main(["llama3_8b", "--grad", "--dp", "2", "--layers", "2"]) == 0
    assert "VERIFIED llama3_8b [dp2-grad]" in capsys.readouterr().out
    assert cli.main(["llama3_8b", "--tp", "4", "--layers", "2", "--lint", "--quiet"]) == 0
    assert cli.main(["lint", "--arch", "llama3_8b", "--quiet"]) == 0
    assert cli.main(["lint"]) == 2
    assert "not ported" not in capsys.readouterr().err
    rep = Session().verify("llama3_8b", Plan(tp=4, layers=LAYERS), lint=True)
    assert rep.verified and rep.lint["ok"] and rep.scenarios[0]["lint_ok"] is True
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "partial-leak" in out and "collective-axis" in out
    assert "tp-forward" in out and "llama3_8b" in out and "dp-grad" in out
    assert "tp-decode" in out and "sp-forward" in out and "chatglm3_6b" in out
    assert "dp-forward" in out and "gemma_2b" in out
    assert "stage" in out and "tpdp-forward" in out


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
    cells = {c.injector: (c.outcome, c.localized, c.lint_detected) for c in got.cells}
    assert cells == {c.injector: (c.outcome, c.localized, c.lint_detected)
                     for c in want.cells}
    assert got.ok and got.detected == 9 and got.missed == 0
    assert got.false_positives == 0 and got.localization_rate == 1.0
    assert {c.injector for c in got.cells if c.outcome == "skipped"} == {
        "wrong_all_gather_dim", "wrong_scatter_dim"}
    hits = sum(c.lint_detected for c in got.cells if c.injector and c.outcome != "skipped")
    assert hits and f"lint tier: {hits}/9 injected cells flagged" in got.summary()


@pytest.mark.parametrize("arch,scenarios,detected", [
    ("llama3_8b", ["tp-decode", "sp-forward"], 15),
    ("mamba2_130m", ["tp-forward"], 8),
    ("gemma_2b", ["tp-forward", "dp-forward"], 13),
])
def test_serving_sp_and_ssm_campaign_cells_match_jax(arch, scenarios, detected):
    got = run_campaign([arch], tp=4, dp=2, scenarios=scenarios)
    want = jrun_campaign([arch], tp=4, dp=2, scenarios=scenarios)
    cells = {(c.scenario, c.injector): (c.outcome, c.localized, c.lint_detected)
             for c in got.cells}
    assert cells == {(c.scenario, c.injector): (c.outcome, c.localized, c.lint_detected)
                     for c in want.cells}
    assert got.ok and got.detected == detected and got.missed == 0
    assert got.false_positives == 0 and got.localization_rate == 1.0


def test_unported_campaign_scenarios_are_not_missed():
    """Every campaign scenario is ported: the dp-grad row (the last one
    ported) verifies clean and detects a dropped gradient psum, localized."""
    rep = run_campaign(["llama3_8b"], tp=4, dp=2, scenarios=["tp-forward", "dp-grad"],
                       injectors=["drop_all_reduce"])
    dp = {c.injector: c for c in rep.cells if c.scenario == "dp-grad"}
    assert dp[""].outcome == "clean_pass"
    assert dp["drop_all_reduce"].outcome == "detected" and dp["drop_all_reduce"].localized
    assert rep.ok and rep.missed == 0 and rep.detected == 2
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
