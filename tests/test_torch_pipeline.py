"""Pipeline stages in the port against the JAX package.

``pipeline_forward`` on 2 and 4 gloo CPU ranks (a ("pod",) mesh) equals the
JAX ``pipeline_forward`` run as tests/test_pipeline.py runs it (a
subprocess with host devices forced), on the same numpy inputs from a seed,
in f32 at ``rtol=atol=1e-5``.  The pipeline x TP program of
``spmd.pipeline_tp_forward`` (2 stages x TP 2 on four gloo ranks, SMOKE
llama3_8b) equals the single-device forward at the same tolerance.  The
``stage`` scenario gives the reference's verdicts, per-scenario memo hits,
``base_cached`` and live-node op histograms (up to ``EMBED_DIFF`` on the
first stage, and one ``convert`` for each SSM layer and each layer with
padded experts in a stage, as test_torch_verify_moe.py explains) for every
arch of the zoo at SMOKE size, and the reference's ``PlanError`` where the
depth does not divide into the stages."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.verify import Plan as JPlan  # noqa: E402
from repro.verify import Session as JSession  # noqa: E402
from repro.verify import session as jsession_mod  # noqa: E402
from repro.verify.plan import PlanError as JPlanError  # noqa: E402
from repro.verify.scenarios import build_pair as jbuild_pair  # noqa: E402
from repro.verify.scenarios.pipeline import stage_pair as jstage_pair  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, EXTRA_IDS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.verify import Plan, Session  # noqa: E402
from repro_torch.verify import session as session_mod  # noqa: E402
from repro_torch.verify.plan import PlanError  # noqa: E402
from repro_torch.verify.scenarios import build_pair, round_layers  # noqa: E402
from repro_torch.verify.scenarios.pipeline import stage_pair  # noqa: E402
from test_torch_verify import EMBED_DIFF, _live_ops  # noqa: E402

_SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-5
SEED = 3
ARCHS = sorted(set(ARCH_IDS) | set(EXTRA_IDS))


def _jax_pipeline(path: Path) -> np.ndarray:
    """The JAX ``pipeline_forward`` over a ("pod",) mesh of host devices on
    the weights and microbatches saved at ``path``."""
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.compat import shard_map
        from repro.parallel.pipeline import pipeline_forward

        data = np.load({str(path)!r})
        Ws, x = jnp.asarray(data["w"]), jnp.asarray(data["x"])
        n = Ws.shape[0]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(n), ("pod",))
        fn = shard_map(
            lambda w, xx: pipeline_forward(lambda p, h: jnp.tanh(h @ p[0]), w, xx,
                                           n_stages=n),
            mesh=mesh, in_specs=(P("pod"), P()), out_specs=P(), check_vma=False)
        with mesh:
            np.save({str(path.with_suffix(".out.npy"))!r}, np.asarray(jax.jit(fn)(Ws, x)))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=_SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return np.load(path.with_suffix(".out.npy"))


def _pipeline_rank(rank, world, ws, x):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.parallel.pipeline import pipeline_forward

    mesh = make_mesh((world,), ("pod",), device_type="cpu")
    ctx = ParallelCtx.from_mesh(mesh)
    return pipeline_forward(lambda w, h: torch.tanh(h @ w), ws[rank], x, n_stages=world,
                            ctx=ctx)


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_forward_matches_jax(stages, tmp_path):
    rng = np.random.default_rng(stages)
    ws = (rng.standard_normal((stages, 8, 8)) * 0.3).astype(np.float32)
    x = rng.standard_normal((6, 2, 8)).astype(np.float32)
    np.savez(tmp_path / "io.npz", w=ws, x=x)
    want = _jax_pipeline(tmp_path / "io.npz")
    ref = x
    for w in ws:  # the stages one after another
        ref = np.tanh(ref @ w)
    np.testing.assert_allclose(want, ref, rtol=TOL, atol=TOL)
    ranks = spmd.run(_pipeline_rank, stages, (torch.from_numpy(ws), torch.from_numpy(x)),
                     timeout=300)
    for got in ranks:  # every rank holds the last stage's outputs
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_pipeline_tp_program_equals_single_device():
    """2 stages x TP 2 on four gloo ranks, 4 layers, 4 microbatches of one
    sequence: every rank's vocab shard of the logits."""
    cfg = dataclasses.replace(get_config("llama3_8b", smoke=True), dtype="float32",
                              n_layers=4)
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=torch.Generator().manual_seed(1))
    model = Model(cfg, impl="reference", device="cpu")
    with torch.inference_mode():
        want = model.forward(model.init(torch.Generator().manual_seed(SEED)),
                             {"tokens": tokens})
    ranks = spmd.run(spmd.pipeline_tp_forward, 4,
                     (cfg, SEED, tokens, 2, 4, "reference", "cpu"), timeout=300)
    v = cfg.vocab_p // 2
    assert sorted((r["pod"], r["model"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        torch.testing.assert_close(r["logits"], want[..., r["model"] * v:(r["model"] + 1) * v],
                                   rtol=TOL, atol=TOL)


def _stage_diff(arch: str, stg: int, side: str) -> dict:
    """The live-op difference of stage ``stg`` (of 2) against the reference."""
    cfg = round_layers(get_config(arch, smoke=True), None, stages=2)
    per = cfg.n_layers // 2
    layers = range(stg * per, (stg + 1) * per)
    embed = EMBED_DIFF[side] if stg == 0 and cfg.frontend != "audio_frames" else {}
    padded = sum(cfg.is_moe_layer(i) for i in layers) if (
        cfg.n_experts_padded > cfg.n_experts) else 0
    segsum = sum(not cfg.is_attn_layer(i) for i in layers)
    moe = any(cfg.is_moe_layer(i) for i in layers)
    convert = embed.get("convert", 0) - padded - segsum
    const = embed.get("const", 0) - bool(padded) - bool(segsum and moe)
    return dict(embed, **({"convert": convert} if convert else {}),
                **({"const": const} if const else {}))


def per_scenario(session, module, arch: str, plan, config) -> list:
    """(scenario, verified, memo hits, base_cached) of each scenario of
    ``plan``, each run on its own."""
    cfg_h = module._cfg_hash(config(arch, smoke=plan.smoke))
    out = []
    for scen in plan.scenarios():
        rep = session._run_scenario(arch, cfg_h, plan, scen, session.options
                                    or module.VerifyOptions(), None)
        out.append((scen.name, rep.verified, rep.cache.memo_hits,
                    rep.cache.base_trace_cached))
    return out


@pytest.fixture(scope="module")
def sessions():
    with Session() as s, JSession() as js:
        yield s, js


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_verdicts_match_jax(arch, sessions):
    s, js = sessions
    plan, jplan = Plan.pipeline(stages=2, tp=2, smoke=True), JPlan.pipeline(
        stages=2, tp=2, smoke=True)
    got, want = s.verify(arch, plan), js.verify(arch, jplan)
    assert got.verified == want.verified is True
    assert got.outputs_ok == want.outputs_ok
    assert got.cache.memo_hits == want.cache.memo_hits
    assert [r["scenario"] for r in got.scenarios] == [r["scenario"] for r in want.scenarios] \
        == ["stage0", "stage1"]
    assert (per_scenario(s, session_mod, arch, plan, get_config)
            == per_scenario(js, jsession_mod, arch, jplan, jget_config))
    for scen, jscen in zip(plan.scenarios(), jplan.scenarios()):
        pair = build_pair(arch, plan, scen, stamp=False)
        jpair = jbuild_pair(arch, jplan, jscen, stamp=False)
        for side in ("base", "dist"):
            t, j = _live_ops(getattr(pair, side)), _live_ops(getattr(jpair, side))
            diff = {op: t[op] - j[op] for op in t | j if t[op] != j[op]}
            assert diff == _stage_diff(arch, scen.stage, side), (scen.name, side, diff)


def test_stage_memo_hits_at_full_width():
    """llama3_8b at full width, 8 layers in 2 stages of TP 4: each stage's
    layers after its second replay from the memo, as in the reference."""
    plan, jplan = (Plan.pipeline(stages=2, tp=4, layers=8),
                   JPlan.pipeline(stages=2, tp=4, layers=8))
    with Session() as s, JSession() as js:
        got = per_scenario(s, session_mod, "llama3_8b", plan, get_config)
        want = per_scenario(js, jsession_mod, "llama3_8b", jplan, jget_config)
    assert got == want
    assert all(v for _, v, _, _ in got) and sum(h for _, _, h, _ in got) > 0


def test_indivisible_depth_is_jax_plan_error():
    """A depth that does not divide into the stages: the reference's text."""
    cfg = dataclasses.replace(get_config("llama3_8b", smoke=True), n_layers=3)
    jcfg = dataclasses.replace(jget_config("llama3_8b", smoke=True), n_layers=3)
    with pytest.raises(PlanError) as got:
        stage_pair("llama3_8b", cfg, 2, 0, 2, 1, 32)
    with pytest.raises(JPlanError) as want:
        jstage_pair("llama3_8b", jcfg, 2, 0, 2, 1, 32)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(tp=2, stages=4),             # stages require mode="pipeline"
    dict(tp=2, stages=1, mode="pipeline"),
    dict(tp=1, stages=4, mode="pipeline"),   # per-stage tp needed
    dict(tp=2, dp=2, stages=2, mode="pipeline"),
    dict(tp=4, composite=True),       # composite needs dp too
    dict(dp=2, composite=True),       # ... and tp
    dict(tp=4, dp=2, composite=True, sp=True),
    dict(tp=4, dp=2, composite=True, mode="decode"),
])
def test_plan_errors_are_jax_plan_errors(kw):
    with pytest.raises(PlanError) as got:
        Plan(**kw)
    with pytest.raises(JPlanError) as want:
        JPlan(**kw)
    assert str(got.value) == str(want.value)
