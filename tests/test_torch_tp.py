"""Megatron TP on gloo ranks on the CPU equals the single-device port, the
counterpart of the first check of tests/test_tp_equivalence.py (there a
shard_map over 8 host devices): llama3_8b and qwen3_4b SMOKE in f32, at
TP 2 and TP 4, each rank holding its shard of one single-device parameter
set (``param_specs``).  The rows are split over ranks for the
row-parallel sums only, so the logits agree to f32 rounding: relative RMS
error at most 1e-5 (about 5e-7 measured).  The same holds for the
sequence-parallel forward and for the serving step: each decode step's
logits, and each rank's final cache shards (``cache_specs``), against the
single-device ``decode_step``, each leaf to the same relative RMS error.
The data-parallel forward (every rank holding every parameter, the batch
split by rows) gives each rank its rows of the single-device logits, and
the data axis' psum and pmean are all_reduces over the ranks.  The
frontends (hubert_xlarge's frames, internvl2_26b's patch prefix) under TP
and SP: under SP every rank holds the whole concatenated sequence and takes
its chunk with ``repro_torch::dynamic_slice`` at its rank."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402
from repro_torch.parallel.sharding import (P, batch_spec, cache_specs,  # noqa: E402
                                           param_specs, shard_params)
from repro_torch.tree import tree_leaves  # noqa: E402

REL_RMS = 1e-5
SEED = 3


def _cfg(arch, tp):
    # the smoke configs' 2 KV heads, padded to the TP degree like CONFIG's 8 to 16
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    return cfg if cfg.ssm_state else dataclasses.replace(cfg, n_kv_heads_padded=max(tp, 2))


def _rel(got, want):
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["llama3_8b", "qwen3_4b"])
def test_tp_logits_equal_single_device(arch, tp):
    cfg = _cfg(arch, tp)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    model = Model(cfg, impl="reference", device="cpu")
    params = model.init(torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        want = model.forward(params, {"tokens": tokens})
    ranks = spmd.run(spmd.tp_forward, tp, (cfg, SEED, tokens, "reference", "cpu"),
                     timeout=300)
    shards = [r["logits"] for r in ranks]
    assert all(s.shape == (2, 16, cfg.vocab_p // tp) for s in shards)
    got = torch.cat(shards, dim=-1)
    assert _rel(got, want) <= REL_RMS


@pytest.mark.parametrize("tp", [2, 4])
def test_sp_logits_equal_single_device(tp):
    cfg = _cfg("llama3_8b", tp)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(2))
    model = Model(cfg, impl="reference", device="cpu")
    params = model.init(torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        want = model.forward(params, {"tokens": tokens})
    ranks = spmd.run(spmd.tp_forward, tp, (cfg, SEED, tokens, "reference", "cpu", True),
                     timeout=300)
    got = torch.cat([r["logits"] for r in ranks], dim=-1)
    assert got.shape == want.shape
    assert _rel(got, want) <= REL_RMS


@pytest.mark.parametrize("arch,tp,sp", [("hubert_xlarge", 4, False), ("hubert_xlarge", 2, True),
                                        ("internvl2_26b", 2, False), ("internvl2_26b", 4, True)])
def test_frontend_tp_and_sp_logits_equal_single_device(arch, tp, sp):
    cfg = _cfg(arch, tp)
    gen = torch.Generator().manual_seed(6)
    if cfg.frontend == "audio_frames":
        batch = {"frames": torch.randn((2, 16, cfg.d_model), generator=gen)}
    else:
        batch = {"vision_embeds": torch.randn((2, cfg.frontend_len, cfg.frontend_dim),
                                              generator=gen),
                 "tokens": torch.randint(0, cfg.vocab, (2, 16), generator=gen)}
    model = Model(cfg, impl="reference", device="cpu")
    params = model.init(torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        want = model.forward(params, batch)
    ranks = spmd.run(spmd.tp_forward, tp, (cfg, SEED, batch, "reference", "cpu", sp),
                     timeout=300)
    got = torch.cat([r["logits"] for r in ranks], dim=-1)
    assert got.shape == want.shape
    assert _rel(got, want) <= REL_RMS


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", ["gemma_2b", "mamba2_130m"])
def test_dp_logits_equal_single_device(arch, dp):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=torch.Generator().manual_seed(5))
    model = Model(cfg, impl="reference", device="cpu")
    with torch.inference_mode():
        want = model.forward(model.init(torch.Generator().manual_seed(SEED)),
                             {"tokens": tokens})
    ranks = spmd.run(spmd.dp_forward, dp, (cfg, SEED, tokens, "kernel", "cpu"), timeout=300)
    rows = 4 // dp
    for rank, out in enumerate(ranks):
        assert out["logits"].shape == (rows, 16, cfg.vocab_p)
        assert _rel(out["logits"], want[rank * rows:(rank + 1) * rows]) <= REL_RMS


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_130m"])
def test_tp_decode_equals_single_device(arch, tp):
    cfg = _cfg(arch, tp)
    steps, max_len = 6, 8
    tokens = torch.randint(0, cfg.vocab, (2, steps), generator=torch.Generator().manual_seed(4))
    model = Model(cfg, impl="reference", device="cpu")
    params = model.init(torch.Generator().manual_seed(SEED))
    caches = model.init_cache(2, max_len)
    want = []
    with torch.inference_mode():
        for t in range(steps):
            logits, caches = model.decode_step(params, tokens[:, t], caches, t)
            want.append(logits)
    ranks = spmd.run(spmd.tp_decode, tp, (cfg, SEED, tokens, max_len, "cpu"), timeout=300)
    got = torch.cat([r["logits"] for r in ranks], dim=-1)
    assert got.shape == (steps, 2, cfg.vocab_p)
    for t in range(steps):
        assert _rel(got[t], want[t]) <= REL_RMS, t
    specs = cache_specs(caches)
    for rank, out in enumerate(ranks):
        shard = tree_leaves(shard_params(caches, specs, rank, tp))
        for a, b in zip(tree_leaves(out["caches"]), shard):
            assert a.shape == b.shape
            assert _rel(a, b) <= REL_RMS


def test_shard_params_follows_param_specs():
    cfg = _cfg("llama3_8b", 4)
    params = Model(cfg, impl="reference", device="cpu").init(torch.Generator().manual_seed(0))
    specs = param_specs(params)
    assert specs["embed"]["w"] == P("model", None)
    assert specs["blocks"][0]["attn"]["wo"]["w"] == P(None, "model", None)
    assert specs["blocks"][0]["mlp"]["wg"]["w"] == P(None, None, "model")
    shard = shard_params(params, specs, 1, 4)
    wq, wo = params["blocks"][0]["attn"]["wq"]["w"], params["blocks"][0]["attn"]["wo"]["w"]
    n = wq.shape[-1] // 4
    assert torch.equal(shard["blocks"][0]["attn"]["wq"]["w"], wq[..., n:2 * n])
    assert torch.equal(shard["blocks"][0]["attn"]["wo"]["w"], wo[:, n:2 * n])
    assert torch.equal(shard["ln_f"]["s"], params["ln_f"]["s"])


def _collectives_rank(rank, world):
    ctx = ParallelCtx.tensor_parallel(world, rank=torch.tensor(rank))
    dp = ParallelCtx(dp_axis=("data",), dp_size=world)
    cp = ParallelCtx(cp_axis="data", cp_size=world)
    sp = ParallelCtx.tensor_parallel(world, rank=torch.tensor(rank), sp=True)
    x = torch.arange(6.0).reshape(2, 3) + 10 * rank
    ones = torch.ones(2 * world, 3) * (rank + 1)
    seq = torch.arange(2.0 * 2 * world * 3).reshape(2, 2 * world, 3) * (rank + 1)
    # a clone waits on the functional collective's result
    return {"sum": ctx.psum_tp(x).clone(), "max": ctx.pmax_tp(x).clone(),
            "gather": ctx.gather_tp(x, 1).clone(),
            "scatter": ctx.scatter_tp(ones, 0).clone(), "index": int(ctx.tp_index()),
            "sp_enter": ctx.sp_enter(x).clone(), "sp_scatter": sp.sp_enter(seq).clone(),
            "sp_gather": sp.sp_exit(seq[:, :2]).clone(),
            "psum_dp": dp.psum_dp(x).clone(), "pmean_dp": dp.pmean_dp(x).clone(),
            "psum_cp": cp.psum_cp(x).clone(), "pmax_cp": cp.pmax_cp(x).clone()}


def test_collectives_on_gloo_ranks():
    world = 2
    xs = [torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(world)]
    for rank, out in enumerate(spmd.run(_collectives_rank, world, timeout=120)):
        assert out["index"] == rank
        assert torch.equal(out["sum"], xs[0] + xs[1])
        assert torch.equal(out["sp_enter"], xs[0] + xs[1])
        assert torch.equal(out["max"], torch.maximum(xs[0], xs[1]))
        assert torch.equal(out["gather"], torch.cat(xs, dim=1))
        assert torch.equal(out["scatter"], torch.full((2, 3), 3.0))
        # sequence parallelism: scatter and gather along the sequence (dim 1)
        seq = torch.arange(2.0 * 2 * world * 3).reshape(2, 2 * world, 3)
        assert torch.equal(out["sp_scatter"], 3 * seq[:, 2 * rank:2 * rank + 2])
        assert torch.equal(out["sp_gather"], torch.cat(
            [seq[:, :2] * (r + 1) for r in range(world)], dim=1))
        # the data axis alone: psum and pmean over the ranks
        assert torch.equal(out["psum_dp"], xs[0] + xs[1])
        assert torch.equal(out["pmean_dp"], (xs[0] + xs[1]) / 2)
        # the context-parallel axis alone (the default group): its psum and
        # pmax, the flash-decode merge's
        assert torch.equal(out["psum_cp"], xs[0] + xs[1])
        assert torch.equal(out["pmax_cp"], torch.maximum(xs[0], xs[1]))
    # beside tensor parallelism (tp x dp over a (data, model) mesh), each
    # sum runs on its own axis' group: over 2 and over 2 of the 4 ranks
    for rank, out in enumerate(spmd.run(_mesh_collectives_rank, 4, timeout=120)):
        d, m = divmod(rank, 2)
        assert (out["data"], out["model"], out["ranks"]) == (d, m, (d, m))
        assert torch.equal(out["psum_tp"], torch.tensor([2.0 * d + 1 + 2 * d + 2]))
        assert torch.equal(out["psum_dp"], torch.tensor([2.0 * m + 4]))
        assert torch.equal(out["pmean_dp"], torch.tensor([m + 2.0]))
        assert out["sizes"] == (2, 2, 2)
        # the data axis as the context-parallel one: its rank tensor, and
        # its sums on its own group
        assert out["cp"] == (d, 2.0 * m + 4, 2.0 + m + 1)
    assert ParallelCtx.single().psum_dp(xs[0]) is xs[0]
    assert ParallelCtx.single().psum_cp(xs[0]) is xs[0]
    assert batch_spec({"tokens": xs[0]}, "data") == {"tokens": P("data", None)}


def _mesh_collectives_rank(rank, world):
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(tp=2, dp=world // 2, device_type="cpu")
    ctx = ParallelCtx.from_mesh(mesh)
    cp = ParallelCtx.from_mesh(mesh, dp=None, cp="data")
    x = torch.tensor([rank + 1.0])
    return {"data": mesh.get_local_rank("data"), "model": mesh.get_local_rank("model"),
            "ranks": (int(ctx.axis_index("data")), int(ctx.tp_index())),
            "psum_tp": ctx.psum_tp(x).clone(), "psum_dp": ctx.psum_dp(x).clone(),
            "pmean_dp": ctx.pmean_dp(x).clone(),
            "sizes": (ctx.tp_size, ctx.dp_size, ctx.ep_size),
            "cp": (int(cp.cp_index()), float(cp.psum_cp(x)), float(cp.pmax_cp(x)))}


def test_a_failing_rank_is_reported():
    with pytest.raises(RuntimeError, match="a rank failed"):
        spmd.run(_fail_on_rank_1, 2, timeout=120)


def _fail_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("planted")
    return rank
