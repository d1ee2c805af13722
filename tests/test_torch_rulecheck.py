"""The port's rule-registry static checker against the JAX package's: the
shipped registry's producer/consumer matrix is the reference's (the rules
are copies), each defect class trips on a synthetic registry built to
exhibit it, and the ``rulecheck`` verb follows the CLI's exit codes."""
import json

import pytest

pytest.importorskip("torch")

from repro.analysis import check_registry as jcheck_registry  # noqa: E402

from repro_torch.analysis import check_registry, trace_ops  # noqa: E402
from repro_torch.core.relations import DUP, LOOPRED, SHARD, SLICEGRP  # noqa: E402
from repro_torch.core.rules.registry import DEFAULT_REGISTRY, RuleRegistry  # noqa: E402
from repro_torch.verify.cli import main as cli_main  # noqa: E402


def _registry(*rules):
    """RuleRegistry from (name, ops, consumes, produces) tuples."""
    reg = RuleRegistry()
    for name, ops, consumes, produces in rules:
        reg.rule(name, ops, consumes=consumes, produces=produces)(
            lambda prop, node: None)
    return reg


def _sliceops_registry(produces):
    reg = RuleRegistry()

    def rule_slice(prop, node):
        return None

    rule_slice.__module__ = "tests.synthetic.sliceops"
    reg.rule("slice_rule", ["slice"], consumes=[SHARD], produces=produces)(rule_slice)
    return reg


def test_shipped_registry_matches_jax():
    """Everything but ``uncovered_ops`` (it comes from traces) is the
    reference's: the same rules, kinds, producers, consumers and drift scan
    over the port's own rule sources."""
    got, want = check_registry().to_dict(), jcheck_registry().to_dict()
    assert got.pop("uncovered_ops") == want.pop("uncovered_ops") == []
    assert got == want
    assert got["ok"] and got["num_rules"] == len(DEFAULT_REGISTRY.rules)


def test_shipped_registry_covers_zoo_ops():
    """Coverage against the port's traces: informational, never gates."""
    rep = check_registry(traced_ops=trace_ops(["gemma_2b"], tp=4))
    assert rep.ok, rep.summary()
    assert isinstance(rep.uncovered_ops, list) and rep.num_ops > 0


@pytest.mark.parametrize("case", ["dead", "alive_empty", "orphan", "seeded", "unproduced",
                                  "drift", "declared"])
def test_synthetic_defects_trip(case, tmp_path):
    if case == "dead":  # consumes loopred, which nothing produces or seeds
        rep = check_registry(_registry(("alive", ["dot"], [SHARD], [SHARD]),
                                       ("dead", ["dot"], [LOOPRED], [SHARD])),
                             rules_dir=tmp_path)
        assert not rep.ok and [r["rule"] for r in rep.dead_rules] == ["dead"]
    elif case == "alive_empty":  # fire-on-any-change rules are never dead
        rep = check_registry(_registry(("congruence", ["dot"], [], [DUP])),
                             rules_dir=tmp_path)
        assert not rep.dead_rules
    elif case == "orphan":  # slicegrp produced, consumed by nothing
        rep = check_registry(_registry(("producer", ["slice"], [SHARD], [SLICEGRP]),
                                       ("user", ["dot"], [SHARD], [SHARD])),
                             rules_dir=tmp_path)
        assert SLICEGRP in rep.orphan_kinds and not rep.ok
    elif case == "seeded":  # dup/shard are seeded and output-checked
        rep = check_registry(_registry(("elem", ["add"], [DUP, SHARD], [DUP, SHARD])),
                             rules_dir=tmp_path)
        assert rep.ok, rep.summary()
    elif case == "unproduced":
        rep = check_registry(_registry(("reader", ["concat"], [SLICEGRP, SHARD],
                                        [SHARD])), rules_dir=tmp_path)
        assert SLICEGRP in rep.unproduced_consumed and not rep.ok
    elif case == "drift":  # the source builds SLICEGRP and reads LOOPRED
        (tmp_path / "sliceops.py").write_text(
            "def rule_slice(prop, node):\n"
            "    prop.emit(Fact(SLICEGRP, 0, 0, 2, lay))\n"
            "    for f in prop.store.facts_kind(0, LOOPRED):\n"
            "        pass\n")
        rep = check_registry(_sliceops_registry([SHARD]), rules_dir=tmp_path)
        directions = {(d["kind"], d["direction"]) for d in rep.drift}
        assert {(SLICEGRP, "produces"), (LOOPRED, "consumes")} <= directions
        assert not rep.ok
    else:  # the rule declares what its source does
        (tmp_path / "sliceops.py").write_text(
            "def rule_slice(prop, node):\n"
            "    prop.emit(Fact(SLICEGRP, 0, 0, 2, lay))\n")
        rep = check_registry(_sliceops_registry([SHARD, SLICEGRP]), rules_dir=tmp_path)
        assert not rep.drift, rep.summary()


def test_cli_rulecheck_exit_codes(tmp_path):
    out = tmp_path / "rc.json"
    assert cli_main(["rulecheck", "--json", str(out)]) == 0
    d = json.loads(out.read_text())
    assert d["ok"] and d["num_rules"] == len(DEFAULT_REGISTRY.rules)
    assert cli_main(["rulecheck", "--ops-from", "nope"]) == 2
