"""The port's MoE layers on the CPU against the JAX package's: the same
numpy inputs and weights (carried with ``params_from_jax``) through each
MoE function of ``models/mlp.py`` (the capacity dispatch, the dense-masked
and expert-parallel verification formulations and the dense router mask)
for the five MoE configs at SMOKE size, in f32 and bf16, with the
tolerances of ``tests/test_kernels.py``.  Edge cases: capacity that drops
pairs, padded experts (never routed), a tie in the router (``lax.top_k``
takes the lower index), and the overflow row of the dispatch buffer, which
several dropped pairs write and nothing reads.  ``Model.forward`` and
``decode_step`` of granite_moe_3b, moonshot_v1_16b, mixtral_8x7b and
jamba_1_5_large give the JAX model's logits and caches; the decode step
routes its two tokens with C = 1 and drops a pair where both pick one
expert, as the reference does."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.parallel.ctx import ParallelCtx as JaxCtx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PORT_FIELDS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402
from test_torch_model import _assert_close, _np  # noqa: E402

MOE = ["granite_moe_3b", "moonshot_v1_16b", "mixtral_8x7b", "mixtral_8x22b",
       "jamba_1_5_large"]
MODELS = ["granite_moe_3b", "moonshot_v1_16b", "mixtral_8x7b", "jamba_1_5_large"]
FNS = ["moe_fwd", "moe_dense_fwd", "moe_ep_fwd"]
# tests/test_kernels.py's tolerances
TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
# Whole models in bf16 are held to relative RMS error instead.  A bf16
# rounding that moves a token's router probabilities across a near-tie
# (a top-k gap of 3e-4 at moonshot's layer 1) sends it to other experts,
# and the logits of that token move by up to 0.94: the JAX model's own
# eager run differs from its jitted one by up to 0.088 (granite), 0.047
# and 0.131 (moonshot forward, decode), 0.025 (mixtral) and 0.18 (jamba),
# in rel RMS of the logits.  The port differs from the jitted model by
# 0.0095, 0.046 and 0.131, 0.024, and 0.068 (jamba, held to the SSM
# limits of test_torch_model.py).  A dispatch position off by one moves
# them by 0.066-0.21 (forward) and 0.27-0.69 (decode), which the f32
# cases and the per-function bf16 cases above catch exactly.
MOE_BF16_REL_RMS = 0.15


def _assert_model_close(got, want, dtype: str, cfg, kind: str = "logits"):
    if dtype == "bfloat16" and not cfg.ssm_state and kind == "logits":
        got, want = _np(got), _np(want)
        assert got.shape == want.shape
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= MOE_BF16_REL_RMS, rel
    else:
        _assert_close(got, want, dtype, cfg, kind)


def _configs(arch: str, dtype: str, **change):
    return tuple(dataclasses.replace(f(arch, smoke=True), dtype=dtype, **change)
                 for f in (jax_config, get_config))


def _layer(jcfg, dtype: str, seed: int = 1):
    """(JAX MoE params, the port's copy) for one layer, drawn by JAX."""
    jp = jax.jit(lambda k: jmlp.moe_init(k, jcfg, dtype=jnp.dtype(dtype)))(
        jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _x(cfg, dtype: str, B=2, S=8, seed=0):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _jax_moe(name, jcfg, jp, jx):
    return jax.jit(lambda p, x: getattr(jmlp, name)(jcfg, JaxCtx.single(), p, x))(jp, jx)


def test_moe_configs_match_jax():
    for arch in MOE:
        for smoke in (False, True):
            j, t = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
            # the port's own fields, which the JAX package lacks, at their defaults
            own = {k: getattr(t, k) for k in PORT_FIELDS}
            assert own == {f.name: f.default for f in dataclasses.fields(t)
                           if f.name in PORT_FIELDS}
            assert dataclasses.asdict(j) == {k: v for k, v in dataclasses.asdict(t).items()
                                             if k not in PORT_FIELDS}
            assert (j.experts, j.param_count(), j.active_param_count(), j.block_period) == (
                t.experts, t.param_count(), t.active_param_count(), t.block_period)
            assert ([j.is_moe_layer(i) for i in range(j.n_layers)]
                    == [t.is_moe_layer(i) for i in range(t.n_layers)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("fn", FNS)
def test_moe_fn_matches_jax(fn, arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _layer(jcfg, dtype)
    jx, tx = _x(tcfg, dtype)
    want = _jax_moe(fn, jcfg, jp, jx)
    got = getattr(mlp, fn)(tcfg, ParallelCtx.single(), tp, tx)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("arch", MOE)
def test_dense_router_weights_match_jax(arch):
    jcfg, tcfg = _configs(arch, "bfloat16")
    jp, tp = _layer(jcfg, "bfloat16")
    jx, tx = _x(tcfg, "bfloat16", B=1, S=16)
    want = jax.jit(lambda p, x: jmlp._dense_router_weights(jcfg, p, x))(jp, jx[0])
    got = mlp._dense_router_weights(tcfg, tp, tx[0])
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    # K weights a token, summing to one, on real experts only
    assert ((got > 0).sum(-1) == tcfg.top_k).all()
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert (got[:, tcfg.n_experts:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite_moe_3b", "moonshot_v1_16b"])
def test_capacity_drops_match_jax(arch, dtype):
    """Capacity at a quarter of the default: most experts overflow; the
    dropped pairs add nothing, in both packages alike."""
    jcfg, tcfg = _configs(arch, dtype, capacity_factor=0.3)
    jp, tp = _layer(jcfg, dtype)
    jx, tx = _x(tcfg, dtype, S=16)
    want = _jax_moe("moe_fwd", jcfg, jp, jx)
    with mlp.record_routing() as routing:
        got = mlp.moe_fwd(tcfg, ParallelCtx.single(), tp, tx)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    T = tx.shape[0] * tx.shape[1]
    C = mlp.moe_capacity(tcfg, T)
    kept = T * tcfg.top_k - int(routing[0]["dropped"])
    assert 0 < kept <= C * tcfg.n_experts
    assert int(routing[0]["dropped"]) > 0
    # infinite capacity is the dense formulation; this one is not
    dense = mlp.moe_dense_fwd(tcfg, ParallelCtx.single(), tp, tx)
    assert not torch.allclose(got.float(), dense.float(), **TOL[dtype])


def test_padded_experts_are_never_routed():
    _, tcfg = _configs("granite_moe_3b", "float32")
    jcfg, _ = _configs("granite_moe_3b", "float32")
    jp, tp = _layer(jcfg, "float32")
    # a router that prefers the padded expert by far: it is still masked
    tp["router"]["w"][:, tcfg.n_experts:] = 100.0
    _, tx = _x(tcfg, "float32", S=16)
    with mlp.record_routing() as routing:
        mlp.moe_fwd(tcfg, ParallelCtx.single(), tp, tx)
    assert int(routing[0]["idx"].max()) < tcfg.n_experts


def test_top_k_breaks_ties_by_the_lower_index():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.5, 0.5, 0.5],
                  [0.0, -1.0, 2.0, 2.0, -1.0]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 3)
    gv, gi = mlp.top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("fn", ["moe_fwd", "moe_dense_fwd"])
def test_router_tie_routes_as_jax(fn):
    """Experts 1 and 2 of mixtral's SMOKE config get equal router columns,
    so every token's logits tie between them: both packages take expert
    1 where only one of the two makes the top 2."""
    jcfg, tcfg = _configs("mixtral_8x7b", "float32")
    jp, tp = _layer(jcfg, "float32")
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 2] = w[:, 1]
    jp = dict(jp, router={"w": jnp.asarray(w)})
    tp["router"]["w"] = torch.from_numpy(w)
    jx, tx = _x(tcfg, "float32", S=16)
    with mlp.record_routing() as routing:
        mlp.moe_fwd(tcfg, ParallelCtx.single(), tp, tx)
    idx = routing[0]["idx"]
    assert ((idx == 1).any(-1) != (idx == 2).any(-1)).any()  # a tie was broken
    assert not (idx == 2).any() or ((idx == 1).any(-1) | ~(idx == 2).any(-1)).all()
    want = _jax_moe(fn, jcfg, jp, jx)
    got = getattr(mlp, fn)(tcfg, ParallelCtx.single(), tp, tx)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_overflow_row_is_never_read(monkeypatch):
    """Dropped and remote pairs all write the dispatch buffer's last row, in
    no fixed order on CUDA: filling that row with NaN after the writes
    changes nothing."""
    _, tcfg = _configs("granite_moe_3b", "bfloat16", capacity_factor=0.3)
    jcfg, _ = _configs("granite_moe_3b", "bfloat16")
    _, tp = _layer(jcfg, "bfloat16")
    _, tx = _x(tcfg, "bfloat16", S=16)
    ctx = ParallelCtx.single()
    want = mlp.moe_fwd(tcfg, ctx, tp, tx)
    copy = torch.Tensor.index_copy_

    def poisoned(buf, dim, index, src):
        out = copy(buf, dim, index, src)
        out[-1] = float("nan")
        return out

    monkeypatch.setattr(torch.Tensor, "index_copy_", poisoned)
    with mlp.record_routing() as routing:
        got = mlp.moe_fwd(tcfg, ctx, tp, tx)
    assert int(routing[0]["dropped"]) > 0
    assert torch.equal(got, want)


def test_overflow_source_entry_is_never_read(monkeypatch):
    """The kernel path's source map: dropped pairs all write its last entry,
    in no fixed order on CUDA; pointing that entry at a real token after the
    writes changes nothing."""
    _, tcfg = _configs("granite_moe_3b", "bfloat16", capacity_factor=0.3)
    jcfg, _ = _configs("granite_moe_3b", "bfloat16")
    _, tp = _layer(jcfg, "bfloat16")
    _, tx = _x(tcfg, "bfloat16", S=16)
    ctx = ParallelCtx.single()
    want = mlp.moe_fwd(tcfg, ctx, tp, tx, impl="kernel")
    source_map = mlp._source_map

    def poisoned(slot, top_k, rows):
        out = source_map(slot, top_k, rows)
        out[-1] = 0
        return out

    monkeypatch.setattr(mlp, "_source_map", poisoned)
    with mlp.record_routing() as routing:
        got = mlp.moe_fwd(tcfg, ctx, tp, tx, impl="kernel")
    assert int(routing[0]["dropped"]) > 0
    assert torch.equal(got, want)
    assert torch.equal(got, mlp.moe_fwd(tcfg, ctx, tp, tx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_capacity_drops_pairs_as_jax(dtype):
    """The serving step routes B tokens at a time: granite's two slots get
    C = ceil(2 * 8 / 48 * 1.25) = 1 (1 at SMOKE size too), so two slots
    that pick one expert drop a pair.  Two equal slots pick the same K
    experts and drop K pairs, in both packages alike."""
    assert mlp.moe_capacity(get_config("granite_moe_3b"), 2) == 1
    jcfg, tcfg = _configs("granite_moe_3b", dtype)
    assert mlp.moe_capacity(tcfg, 2) == 1
    jp, tp = _layer(jcfg, dtype)
    jx, tx = _x(tcfg, dtype, B=1, S=1)
    jx, tx = jnp.concatenate([jx, jx]), torch.cat([tx, tx])  # (2, 1, D)
    want = _jax_moe("moe_fwd", jcfg, jp, jx)
    with mlp.record_routing() as routing:
        got = mlp.moe_fwd(tcfg, ParallelCtx.single(), tp, tx)
    assert int(routing[0]["dropped"]) == tcfg.top_k
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    assert torch.equal(got[1], torch.zeros_like(got[1]))  # the second slot lost both


# -- whole models -------------------------------------------------------------


@functools.cache
def _f32_init(arch: str):
    jcfg = jax_config(arch, smoke=True)
    return jax.jit(JaxModel(dataclasses.replace(jcfg, dtype="float32")).init)(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=[(a, d) for a in MODELS for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(JAX model, JAX params, port config, port params, dtype): one f32
    init, each leaf cast to the type the model's own init gives it."""
    arch, dtype = request.param
    jcfg, tcfg = _configs(arch, dtype)
    jm = JaxModel(jcfg)
    types = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda a, t: a.astype(t.dtype), _f32_init(arch), types)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tcfg, tp, dtype


def _tokens(B=2, S=24, vocab=256, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_moe_model_forward_matches_jax(pair, impl):
    jm, jp, tcfg, tp, dtype = pair
    toks = _tokens()
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got = Model(tcfg, impl=impl, device="cpu").forward(
        tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    _assert_model_close(got, want, dtype, tcfg)


def test_moe_model_decode_matches_jax(pair):
    jm, jp, tcfg, tp, dtype = pair
    tm = Model(tcfg, device="cpu")
    toks = _tokens(S=6, seed=2)
    jcache, tcache = jm.init_cache(2, 8), tm.init_cache(2, 8)
    step = jax.jit(jm.decode_step)
    for t in range(6):
        jlog, jcache = step(jp, jnp.asarray(toks[:, t]), jcache, jnp.int32(t))
        tlog, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, t]).long(), tcache, t)
        _assert_model_close(tlog, jlog, dtype, tcfg)
    for jc, tc in zip(jcache, tcache):
        assert sorted(tc) == sorted(jc)
        for name in jc:
            _assert_model_close(tc[name], jc[name], dtype, tcfg, "cache")


# -- serving --------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite_moe_3b", "moonshot_v1_16b"])
def test_moe_engine_greedy_matches_jax(arch):
    """The serving engine decodes through the capacity dispatch (two slots,
    C = 1) and gives the JAX engine's greedy tokens for the same f32
    weights."""
    from repro.serve import Engine as JaxEngine
    from repro.serve import ServeConfig as JaxServeConfig
    from repro_torch.serve import Engine, ServeConfig

    jcfg, tcfg = _configs(arch, "float32")
    jm = JaxModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (3, 7, 5, 2)]

    def serve(engine):
        ids = [engine.submit(p, max_new=6) for p in prompts]
        out = engine.run()
        return [out[i] for i in ids]

    want = serve(JaxEngine(jm, jp, JaxServeConfig(max_len=32, batch_slots=2)))
    got = serve(Engine(Model(tcfg, device="cpu"), tp, ServeConfig(max_len=32, batch_slots=2)))
    assert got == want and all(len(g) == 6 for g in got)


def test_moe_launcher_serves_and_verifies_as_jax(capsys):
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve as launch_serve

    argv = ["--arch", "granite_moe_3b", "--verify-tp", "2", "--requests", "2",
            "--max-new", "3"]
    assert launch_serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[verify] VERIFIED granite_moe_3b [tp2-decode]" in out
    assert out.count("[done] req") == 2 and "on cpu" in out
    assert jax_serve.main(argv) == 0
