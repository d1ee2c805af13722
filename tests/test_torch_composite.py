"""The tp x dp composite in the port against the JAX package.

``ParallelCtx.from_mesh`` over a (data, model) ``DeviceMesh`` and the
production meshes (built under the tracer's fake process group); the tp x
dp program of ``spmd.tpdp_forward`` (TP 2 x DP 2 on four gloo CPU ranks,
SMOKE llama3_8b) equals the single-device forward in f32 at
``rtol=atol=1e-5``; the ``tpdp-forward`` scenario gives the reference's
verdicts, per-scenario memo hits, ``base_cached`` and live-node op
histograms (the baseline is the TP program, so both sides differ from the
reference by ``EMBED_DIFF["dist"]`` and one ``convert`` an SSM layer) for
every arch of the zoo at SMOKE size, the reference's ``PlanError`` for the
MoE archs, and its failing row under ``drop_all_reduce(index=1)``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.inject import drop_all_reduce as jdrop_all_reduce  # noqa: E402
from repro.verify import Plan as JPlan  # noqa: E402
from repro.verify import Session as JSession  # noqa: E402
from repro.verify import session as jsession_mod  # noqa: E402
from repro.verify.plan import PlanError as JPlanError  # noqa: E402
from repro.verify.scenarios import build_pair as jbuild_pair  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.inject import drop_all_reduce  # noqa: E402
from repro_torch.core.trace import fake_process_group  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402
from repro_torch.parallel.sharding import P, shard_params  # noqa: E402
from repro_torch.verify import Plan, Session  # noqa: E402
from repro_torch.verify import session as session_mod  # noqa: E402
from repro_torch.verify.plan import PlanError  # noqa: E402
from repro_torch.verify.scenarios import build_pair  # noqa: E402
from test_torch_pipeline import ARCHS, per_scenario  # noqa: E402
from test_torch_verify import EMBED_DIFF, _live_ops  # noqa: E402

TOL = 1e-5
SEED = 3


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_context(multi_pod):
    from repro_torch.launch.mesh import dp_axes, make_production_mesh

    with fake_process_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        ctx = ParallelCtx.from_mesh(mesh, dp=dp_axes(mesh))
        groups = {a: mesh.get_group(a).group_name for a in mesh.mesh_dim_names}
    axes = ("pod", "data") if multi_pod else ("data",)
    assert dp_axes(mesh) == ctx.dp_axis == axes
    assert (ctx.tp_axis, ctx.ep_axis, ctx.tp_size, ctx.ep_size) == ("model", "model", 16, 16)
    assert ctx.dp_size == (32 if multi_pod else 16)
    assert ctx.dp_axis_sizes == ((2, 16) if multi_pod else (16,))
    assert len(set(groups.values())) == len(groups)  # one group an axis
    assert all(int(r) == 0 for r in ctx.axis_ranks) and ctx.rank is ctx.axis_index("model")


def test_shard_params_over_two_axes():
    """A spec naming both axes cuts each dim by its own axis, block at the
    rank's coordinate; a spec naming one axis cuts as it does alone."""
    t = torch.arange(4 * 6).reshape(4, 6)
    got = shard_params({"a": t, "b": t}, {"a": P("data", "model"), "b": P(None, "model")},
                       {"data": 1, "model": 2}, {"data": 2, "model": 3})
    assert torch.equal(got["a"], t[2:4, 4:6])
    assert torch.equal(got["b"], shard_params(t, P(None, "model"), 2, 3))


def test_tpdp_program_equals_single_device():
    """TP 2 x DP 2 on four gloo ranks: rank (d, m) holds rows d and vocab
    shard m of the single-device logits."""
    cfg = dataclasses.replace(get_config("llama3_8b", smoke=True), dtype="float32")
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=torch.Generator().manual_seed(1))
    model = Model(cfg, impl="reference", device="cpu")
    with torch.inference_mode():
        want = model.forward(model.init(torch.Generator().manual_seed(SEED)),
                             {"tokens": tokens})
    ranks = spmd.run(spmd.tpdp_forward, 4, (cfg, SEED, tokens, 2, "reference", "cpu"),
                     timeout=300)
    v = cfg.vocab_p // 2
    assert [(r["data"], r["model"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        d, m = r["data"], r["model"]
        torch.testing.assert_close(r["logits"], want[2 * d:2 * d + 2, :, m * v:(m + 1) * v],
                                   rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def sessions():
    with Session() as s, JSession() as js:
        yield s, js


@pytest.mark.parametrize("arch", ARCHS)
def test_composite_verdicts_match_jax(arch, sessions):
    s, js = sessions
    kw = dict(tp=2, dp=2, composite=True, smoke=True)
    plan, jplan = Plan(**kw), JPlan(**kw)
    if get_config(arch, smoke=True).n_experts:
        with pytest.raises(PlanError) as got:
            s.verify(arch, plan)
        with pytest.raises(JPlanError) as want:
            js.verify(arch, jplan)
        assert "MoE" in str(got.value) and str(got.value) == str(want.value)
        return
    got, want = s.verify(arch, plan), js.verify(arch, jplan)
    assert got.verified == want.verified is True
    assert got.outputs_ok == want.outputs_ok
    assert got.cache.memo_hits == want.cache.memo_hits
    assert [r["scenario"] for r in got.scenarios] == ["tp-forward", "tpdp-forward"]
    assert (per_scenario(s, session_mod, arch, plan, get_config)
            == per_scenario(js, jsession_mod, arch, jplan, jget_config))
    cfg = get_config(arch, smoke=True)
    segsum = sum(not cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    scen, jscen = plan.scenarios()[1], jplan.scenarios()[1]
    pair = build_pair(arch, plan, scen, stamp=False)
    jpair = jbuild_pair(arch, jplan, jscen, stamp=False)
    assert pair.mesh_axes == jpair.mesh_axes == ("data", "model")
    for side in ("base", "dist"):
        t, j = _live_ops(getattr(pair, side)), _live_ops(getattr(jpair, side))
        diff = {op: t[op] - j[op] for op in t | j if t[op] != j[op]}
        embed = {} if cfg.frontend == "audio_frames" else EMBED_DIFF["dist"]
        assert diff == dict(embed, **({"convert": -segsum} if segsum else {})), (side, diff)


def test_composite_catches_a_dropped_model_axis_psum():
    """Dropping a model-axis psum desyncs the 2-D program from the TP
    baseline: the tpdp-forward row fails, as in the reference."""
    kw = dict(tp=4, dp=2, composite=True, layers=2)
    with Session() as s, JSession() as js:
        good = s.verify("qwen3_4b", Plan(**kw))
        bad = s.verify("qwen3_4b", Plan(**kw),
                       mutate_dist=lambda gd: drop_all_reduce(gd, index=1).graph)
        jbad = js.verify("qwen3_4b", JPlan(**kw),
                         mutate_dist=lambda gd: jdrop_all_reduce(gd, index=1).graph)
    assert good.verified
    assert not bad.verified and bad.bug_sites
    rows = {r["scenario"]: r["verified"] for r in bad.scenarios}
    assert rows == {r["scenario"]: r["verified"] for r in jbad.scenarios}
    assert not rows["tpdp-forward"]
