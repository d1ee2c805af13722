"""The port's training pieces on the CPU against the JAX package's: the data
stream bit for bit, ``Model.loss`` and its gradients for the six archs of
the reference's TP-equivalence table (f32, remat on in the port, off in
JAX: recomputation changes no value), the LR schedule, three AdamW steps,
the NaN skip-step, the ZeRO-1 shard dims, microbatched gradients, and the
kernels' refusal of autograd (the repair that keeps a trainer on the card
from training with the graph cut at a kernel)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data import make_batch_for as jmake_batch_for  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402

from repro_torch.configs import ShapeSpec, get_config, input_specs  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM, make_batch_for  # noqa: E402
from repro_torch.launch.dryrun import (_f32_like, _opt_specs,  # noqa: E402
                                       _zero_flags_from_specs, _zero_opt_shapes)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.parallel.sharding import P, param_specs  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import TrainConfig, local_grads  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_leaves  # noqa: E402

# the six archs of tests/test_tp_equivalence.py:82-85
ARCHS = ["qwen3_4b", "gemma_2b", "granite_moe_3b", "mamba2_130m", "jamba_1_5_large",
         "hubert_xlarge"]
# f32 tolerances: the repo's kernel tolerance (tests/test_kernels.py:16-17);
# a gradient leaf's absolute tolerance is scaled by its largest entry, since
# the mean loss makes gradients small
TOL = dict(rtol=2e-4, atol=2e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_grad(got, want, what):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=TOL["atol"] * scale,
                               err_msg=what)


def _leaves_by_key(tree):
    return {"/".join(map(str, path)): leaf for path, leaf in tree_flatten_with_path(tree)[0]}


def _jax_leaves_by_key(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in flat}


def _f32(arch):
    return (dataclasses.replace(jax_config(arch, smoke=True), dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True), dtype="float32"))


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (0, 0, 0, 1), (5, 3, 1, 2), (5, 17, 1, 2), (7, 2, 3, 4)])
def test_synthetic_stream_is_jax_bit_for_bit(seed, step, shard, n_shards):
    dcfg = dict(vocab=300, seq_len=32, global_batch=8, seed=seed)
    want = JSyntheticLM(JDataConfig(**dcfg)).batch_at(step, shard=shard, n_shards=n_shards)
    got = SyntheticLM(DataConfig(**dcfg)).batch_at(step, shard=shard, n_shards=n_shards)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", ["qwen3_4b", "internvl2_26b", "hubert_xlarge"])
@pytest.mark.parametrize("seed,step,shard,n_shards", [(0, 0, 0, 1), (3, 5, 1, 2)])
def test_make_batch_for_is_jax_bit_for_bit(arch, seed, step, shard, n_shards):
    """Tokens, labels, patches and frames, typed as ``input_specs`` types
    them (bf16 embeddings compared by their bits)."""
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    S = 2 * cfg.frontend_len if cfg.frontend == "vision_patches" else 16
    want = jmake_batch_for(jcfg, JShapeSpec("t", S, 4, "train"), seed=seed, step=step,
                           shard=shard, n_shards=n_shards)
    got = make_batch_for(cfg, ShapeSpec("t", S, 4, "train"), seed=seed, step=step,
                         shard=shard, n_shards=n_shards)
    specs = input_specs(cfg, ShapeSpec("t", S, 4 // n_shards, "train"))
    assert set(got) == set(want) == set(specs)
    for k, t in got.items():
        assert t.dtype == specs[k].dtype and tuple(t.shape) == specs[k].shape
        w = np.asarray(want[k])
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), w)


# ---------------------------------------------------------------------------
# Model.loss and its gradients


@functools.lru_cache(maxsize=None)
def _jax_case(arch):
    jcfg, _ = _f32(arch)
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    batch = jmake_batch_for(jcfg, JShapeSpec("t", 16, 4, "train"), seed=1)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, batch)
    return params, batch, float(loss), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_jax(arch):
    params, batch, want_loss, want_grads = _jax_case(arch)
    _, cfg = _f32(arch)
    model = Model(cfg, impl="reference", device="cpu")
    loss, grads = local_grads(model, TrainConfig(remat=True), params_from_jax(params),
                              params_from_jax(batch))
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    got, want = _leaves_by_key(grads), _jax_leaves_by_key(want_grads)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        _close_grad(got[k], want[k], k)


def test_vocab_padding_and_offset_in_the_loss():
    """A padded vocab's columns are masked out of the loss: it equals a
    plain cross entropy over the real columns."""
    cfg = dataclasses.replace(get_config("qwen3_4b", smoke=True), dtype="float32",
                              vocab=250, vocab_padded=256)
    model = Model(cfg, impl="reference", device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = SyntheticLM(DataConfig(250, 16, 4, seed=2)).batch_at(0)
    with torch.no_grad():
        logits = model.forward(params, batch).float()[..., :250]
        want = torch.nn.functional.cross_entropy(logits.reshape(-1, 250),
                                                 batch["labels"].reshape(-1).long())
        np.testing.assert_allclose(float(model.loss(params, batch)), float(want), **TOL)


# ---------------------------------------------------------------------------
# optimizer


def test_lr_schedule_equals_jax():
    cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 1000):
        np.testing.assert_allclose(float(opt.lr_schedule(cfg, step)),
                                   float(jopt.lr_schedule(jcfg, step)), rtol=1e-6)
        np.testing.assert_allclose(
            float(opt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))),
            float(jopt.lr_schedule(jcfg, jnp.int32(step))), rtol=1e-6)


def _opt_tree(rng):
    return {"a": {"w": rng.standard_normal((6, 5)).astype(np.float32)},
            "blocks": ({"w": rng.standard_normal((3, 4, 5)).astype(np.float32)},),
            "s": rng.standard_normal((7,)).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gscale", [0.01, 10.0])  # clip inactive / active
def test_adamw_three_steps_equal_jax(dtype, gscale, monkeypatch):
    """Three in-place AdamW steps (with the leaf update cut into slices of
    at most 8 elements, so every leaf goes through slices) against JAX's
    functional update: params, m, v, step, grad_norm and lr.  bf16 params
    are held to one bf16 rounding."""
    monkeypatch.setattr(opt, "_SLICE_ELEMS", 8)
    rng = np.random.default_rng(0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), _opt_tree(rng))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    state, jstate = opt.adamw_init(params), jopt.adamw_init(jparams)
    for _ in range(3):
        g = jax.tree_util.tree_map(lambda a: jnp.asarray(a * gscale, jdt), _opt_tree(rng))
        jparams, jstate, jinfo = jopt.adamw_update(jcfg, jparams, g, jstate)
        params, state, info = opt.adamw_update(
            cfg, params, params_from_jax(jax.tree_util.tree_map(np.asarray, g)), state)
        np.testing.assert_allclose(float(info["grad_norm"]), float(jinfo["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(info["lr"]), float(jinfo["lr"]), rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3
    assert state["step"].dtype == torch.int32
    ptol = dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" else dict(rtol=1e-6, atol=1e-7)
    for got, want, tol in ((params, jparams, ptol), (state["m"], jstate["m"], TOL),
                           (state["v"], jstate["v"], TOL)):
        g, w = _leaves_by_key(got), _jax_leaves_by_key(want)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(_np(g[k]), _np(w[k]), **tol, err_msg=k)


def test_nan_grad_skip_step_equals_jax():
    """A non-finite global norm leaves params, m and v as they were; step
    still increments, in both packages."""
    rng = np.random.default_rng(1)
    tree = _opt_tree(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = params_from_jax(tree)
    cfg, jcfg = opt.AdamWConfig(lr=1.0, warmup_steps=0), jopt.AdamWConfig(lr=1.0,
                                                                          warmup_steps=0)
    state, jstate = opt.adamw_init(params), jopt.adamw_init(jparams)
    good = _opt_tree(rng)
    params, state, _ = opt.adamw_update(cfg, params, params_from_jax(good), state)
    jparams, jstate, _ = jopt.adamw_update(jcfg, jparams, good, jstate)
    bad = _opt_tree(rng)
    bad["a"]["w"][2, 3] = np.nan
    before = [t.clone() for t in tree_leaves((params, state["m"], state["v"]))]
    params, state, info = opt.adamw_update(cfg, params, params_from_jax(bad), state)
    jparams, jstate, jinfo = jopt.adamw_update(jcfg, jparams, bad, jstate)
    assert not np.isfinite(float(info["grad_norm"])) and not np.isfinite(
        float(jinfo["grad_norm"]))
    assert int(state["step"]) == int(jstate["step"]) == 2
    for a, b in zip(before, tree_leaves((params, state["m"], state["v"]))):
        assert torch.equal(a, b)
    for got, want in ((params, jparams), (state["m"], jstate["m"])):
        g, w = _leaves_by_key(got), _jax_leaves_by_key(want)
        for k in w:
            np.testing.assert_allclose(_np(g[k]), _np(w[k]), rtol=1e-6, atol=1e-7)


def test_zero1_shard_dims_equal_jax():
    rng = np.random.default_rng(2)
    tree = _opt_tree(rng)
    for dp in (1, 2, 3, 4):
        got = opt.zero1_shard_flags(params_from_jax(tree), dp)
        want = jopt.zero1_shard_flags(jax.tree_util.tree_map(jnp.asarray, tree), dp)
        assert _leaves_by_key(got) == _jax_leaves_by_key(want)
    for shape, dp, blocked in (((8, 6), 4, ()), ((8, 6), 4, (0,)), ((7, 5), 2, ()),
                               ((), 2, ())):
        assert opt.zero1_shard_dim(shape, dp, blocked) == jopt.zero1_shard_dim(
            shape, dp, blocked)
    z, jz = opt.zero1_init(params_from_jax(tree), 2), jopt.zero1_init(tree, 2)
    assert {k: tuple(v.shape) for k, v in _leaves_by_key(z["m"]).items()} == {
        k: v.shape for k, v in _jax_leaves_by_key(jz["m"]).items()}


def test_zero_flags_from_specs():
    """The first spec-unsharded dim divisible by dp (-1 when none), and the
    moments' specs with that dim over the data axis (the JAX dry run's
    helpers, on qwen3_4b's SMOKE shapes at tp 2, dp 2)."""
    params = Model(get_config("qwen3_4b", smoke=True), device="cpu").param_shapes()
    pspecs = param_specs(params)
    flag_tree = _zero_flags_from_specs(params, 2, pspecs)
    flags = _leaves_by_key(flag_tree)
    assert flags["embed/w"] == 1  # (V, D): V over the model axis
    assert flags["lm_head/w"] == 0  # (D, V): V over the model axis
    assert flags["blocks/0/attn/wq/w"] == 0  # (nb=2, D, H*hd): nb is free
    assert flags["blocks/0/ln1/s"] == 0
    assert flags["ln_f/s"] == 0
    ospecs = _opt_specs(pspecs, zero1=True, dp_last="data", flags=flag_tree)
    m = _leaves_by_key(ospecs["m"])
    assert m["embed/w"] == P("model", "data") and m["lm_head/w"] == P("data", "model")
    assert ospecs["step"] == P()
    odd = _leaves_by_key(_zero_flags_from_specs({"x": torch.empty(3, 5)}, 2,
                                                {"x": P(None, None)}))
    assert odd == {"x": -1}
    shapes = _zero_opt_shapes(params)  # global view: the params' shapes
    assert {k: (v.shape, v.dtype) for k, v in _leaves_by_key(shapes["m"]).items()} == {
        k: (tuple(v.shape), torch.float32) for k, v in _leaves_by_key(params).items()}
    assert _leaves_by_key(_f32_like(params)) == _leaves_by_key(shapes["v"])
    assert shapes["step"].shape == () and shapes["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the trainer


def test_microbatched_grads_equal_jax():
    """``local_grads`` with 4 microbatches: the summed gradients scaled by
    1/4 and the mean loss, against the JAX trainer's ``lax.scan``."""
    jcfg, cfg = _f32("qwen3_4b")
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(3))
    batch = jmake_batch_for(jcfg, JShapeSpec("t", 16, 8, "train"), seed=4)
    jt = jtrainer.TrainConfig(microbatches=4, remat=False)
    want_loss, want = jax.jit(lambda p, b: jtrainer.local_grads(jm, jt, p, b))(params, batch)
    loss, got = local_grads(Model(cfg, impl="reference", device="cpu"),
                            TrainConfig(microbatches=4, remat=False),
                            params_from_jax(params), params_from_jax(batch))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    g, w = _leaves_by_key(got), _jax_leaves_by_key(want)
    for k in w:
        _close_grad(g[k], w[k], k)


# ---------------------------------------------------------------------------
# the kernels refuse autograd


@pytest.mark.parametrize("arch", ["qwen3_4b", "mamba2_130m"])
def test_kernel_path_refuses_autograd(arch):
    """Under grad, a kernel path whose inputs autograd tracks raises (on the
    card its kernel would cut the graph, leaving wq/wk/wv/qnorm/knorm or the
    SSD weights without a gradient); the reference path gives every leaf a
    nonzero gradient; the kernel path still runs under no_grad."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    batch = SyntheticLM(DataConfig(cfg.vocab, 16, 2, seed=0)).batch_at(0)
    kernel = Model(cfg, impl="kernel", device="cpu")
    params = kernel.init(torch.Generator().manual_seed(0))
    blk = params["blocks"][0]
    w = tree_leaves(blk["attn"] if "attn" in blk else blk["ssm"])[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        kernel.forward(params, batch)
    w.requires_grad_(False)
    with torch.no_grad():
        kernel.forward(params, batch)
    with pytest.raises(RuntimeError, match="has no backward"):
        local_grads(kernel, TrainConfig(remat=False), params, batch)
    _, grads = local_grads(Model(cfg, impl="reference", device="cpu"),
                           TrainConfig(remat=False), params, batch)
    norms = {k: float(g.norm()) for k, g in _leaves_by_key(grads).items()}
    assert all(np.isfinite(n) and n > 0 for n in norms.values()), norms
