"""The port's distributed training on four gloo CPU ranks, a (data, model) =
(2, 2) mesh, against the JAX package (f32 SMOKE configs, the JAX weights
carried across):

* the TP loss (pmean over the data axis) equals JAX's single-device loss
  for qwen3_4b, granite_moe_3b and mamba2_130m, and the SP loss qwen3_4b's,
  within the reference's 0.005 relative error (tests/test_tp_equivalence.py);
* each rank's local gradients equal JAX's per-rank gradients on its rows,
  computed under ``jax.vmap(..., axis_name="model")`` (in both packages a
  psum's cotangent is psummed, so some leaves carry up to tp times the
  single-device gradient: the reference's scaling, mirrored on purpose);
* one train step (plain, 4 microbatches, ZeRO-1 with the dry run's shard
  flags, int8 compression) against JAX's single-device step, at the
  reference's bounds: loss relative error < 0.02 and the worst param delta
  < 2e-2 (5e-2 for int8), tests/test_tp_equivalence.py:131-142;
* that step's moments and gradient norm on each rank against JAX's
  ``make_step_fn`` under ``jax.vmap`` over ("data", "model"): a first
  AdamW step moves every parameter by about lr whatever its gradient, so
  the param bound above cannot see the data-axis reduction, its ``/ dp``,
  the ZeRO-1 scatter or the clip; the moments carry the reduced gradient;
* each differentiable collective's gradient (psum, all_gather,
  psum_scatter) against JAX's transpose under ``jax.vmap``, and
  ``allreduce_compressed`` (none, bf16, int8) against JAX's.

One spawn of four ranks runs every program; the tests read its results."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.data import make_batch_for as jmake_batch_for  # noqa: E402
from repro.launch.dryrun import _zero_flags_from_specs as jzero_flags  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.parallel.ctx import ParallelCtx as JParallelCtx  # noqa: E402
from repro.parallel.sharding import param_specs as jparam_specs  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.compression import allreduce_compressed as jallreduce  # noqa: E402
from repro.train.trainer import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.trainer import make_step_fn as jmake_step_fn  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.sharding import param_specs, shard_params  # noqa: E402
from repro_torch.train.compression import allreduce_compressed  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.trainer import TrainConfig  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_map  # noqa: E402

TP, DP = 2, 2
LOSS_ARCHS = ["qwen3_4b", "granite_moe_3b", "mamba2_130m"]
STEPS = {  # variant -> (TrainConfig fields, worst param delta bound)
    "plain": (dict(), 2e-2),
    "micro4": (dict(microbatches=4), 2e-2),
    "zero1": (dict(zero1=True), 2e-2),
    "int8": (dict(grad_compress="int8"), 5e-2),
}
LR = dict(lr=1e-3, warmup_steps=1)
# (name, torch collective on the model axis, its JAX counterpart, weight shape)
COLLECTIVES = {
    "psum": (lambda ctx, x: ctx.psum(x, "model"),
             lambda x: jax.lax.psum(x, "model"), (4, 6)),
    "all_gather": (lambda ctx, x: ctx.all_gather(x, "model", 1),
                   lambda x: jax.lax.all_gather(x, "model", axis=1, tiled=True), (4, 12)),
    "psum_scatter": (lambda ctx, x: ctx.psum_scatter(x, "model", 0),
                     lambda x: jax.lax.psum_scatter(x, "model", scatter_dimension=0,
                                                    tiled=True), (2, 6)),
}
COMPRESS = ("none", "bf16", "int8")
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_kernels.py:16-17, scaled as below
# int8 moments: a local gradient that sits on a rounding boundary of the
# quantizer may round apart in two f32 computations of it, which moves its
# element of m by one quantum (about 1/127 of its block's largest gradient)
# and of v by about twice that share; at most this share of a leaf's
# elements may do so, each within this bound relative to the leaf's max
INT8_FLIPS = (1e-3, 2 / 127)


def _f32(arch):
    return (dataclasses.replace(jax_config(arch, smoke=True), dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True), dtype="float32"))


def _by_key(tree):
    return {"/".join(map(str, p)): v for p, v in tree_flatten_with_path(tree)[0]}


def _jax_by_key(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): v
            for path, v in flat}


def _ranks(rank, world, cases):
    """Every program of this file on one rank."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model
    from repro_torch.parallel.ctx import ParallelCtx

    mesh = make_debug_mesh(TP, DP, device_type="cpu")
    ctx = ParallelCtx.from_mesh(mesh)
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    x, w = cases["coll"]
    out = {"coll": {}, "compress": {}}
    for name, (fn, _, shape) in COLLECTIVES.items():
        xr = x[d, m].clone().requires_grad_(True)
        y = fn(ctx, xr)
        (g,) = torch.autograd.grad((w[:shape[0], :shape[1]] * y).sum(), xr)
        out["coll"][name] = (y.detach(), g)
    for mode in COMPRESS:
        out["compress"][mode] = allreduce_compressed({"g": x[d, m]}, mode, ("data",), ctx)["g"]
    out["loss"] = {}
    for name, (cfg, params, batch, sp) in cases["loss"].items():
        mesh = make_debug_mesh(TP, DP, device_type="cpu")
        ctx = ParallelCtx.from_mesh(mesh, sp=sp)
        d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        model = Model(cfg, ctx, impl="reference", device="cpu")
        shard = shard_params(params, param_specs(params), m, TP)
        rows = batch["labels"].shape[0] // DP
        local = tree_map(lambda x: x[d * rows:(d + 1) * rows], batch)
        with torch.no_grad():
            out["loss"][name] = float(ctx.pmean_dp(model.loss(shard, local)))
    cfg, params, batch = cases["step"]
    out["steps"] = {
        variant: spmd.train_step(rank, world, cfg, params, [batch], TP,
                                 TrainConfig(opt=AdamWConfig(**LR), remat=False, **fields),
                                 device="cpu", grads=variant == "plain")
        for variant, (fields, _) in STEPS.items()}
    return out


@pytest.fixture(scope="module")
def run():
    """JAX's side, then the four ranks."""
    loss_cases, want_loss = {}, {}
    for arch, sp in [(a, False) for a in LOSS_ARCHS] + [("qwen3_4b", True)]:
        jcfg, cfg = _f32(arch)
        jm = JaxModel(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        batch = jmake_batch_for(jcfg, JShapeSpec("t", 16, 4 * DP, "train"), seed=1)
        name = f"{arch}{'-sp' if sp else ''}"
        want_loss[name] = float(jax.jit(jm.loss)(params, batch))
        loss_cases[name] = (cfg, params_from_jax(params), params_from_jax(batch), sp)

    jcfg, cfg = _f32("qwen3_4b")
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    batch = jmake_batch_for(jcfg, JShapeSpec("t", 16, 4 * DP, "train"), seed=1)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, batch)
    jcfg_opt = jopt.AdamWConfig(**LR)
    new_params, _, _ = jopt.adamw_update(jcfg_opt, params, grads, jopt.adamw_init(params))

    # JAX's per-rank local gradients: rank (d, m) runs the TP model on rows d
    md = JaxModel(jcfg, JParallelCtx(tp_axis="model", tp_size=TP, ep_axis="model",
                                     ep_size=TP))
    specs = jparam_specs(jax.eval_shape(lambda: params))

    def shard(a, spec, m):
        for dim, ax in enumerate(tuple(spec)):
            if ax == "model":
                n = a.shape[dim] // TP
                a = jax.lax.slice_in_dim(a, m * n, (m + 1) * n, axis=dim)
        return a

    stacked = jax.tree_util.tree_map(
        lambda a, s: jax.numpy.stack([shard(a, s, m) for m in range(TP)]), params, specs)
    vg = jax.jit(jax.vmap(jax.value_and_grad(md.loss), in_axes=(0, None),
                          axis_name="model"))
    rows = batch["labels"].shape[0] // DP
    rank_grads = [vg(stacked, jax.tree_util.tree_map(lambda x: x[d * rows:(d + 1) * rows],
                                                     batch))[1] for d in range(DP)]

    # JAX's step on every rank: make_step_fn under vmap over ("data", "model"),
    # each rank on its model shard and its rows; (m, v, grad_norm) indexed
    # [data, model]
    mdp = JaxModel(jcfg, JParallelCtx(tp_axis="model", tp_size=TP, ep_axis="model",
                                      ep_size=TP, dp_axis=("data",), dp_size=DP,
                                      dp_axis_sizes=(DP,)))
    flags = jzero_flags(jax.eval_shape(lambda: params), DP, specs)
    by_rank = jax.tree_util.tree_map(lambda x: x.reshape(DP, rows, *x.shape[1:]), batch)

    def zero_moments(p, flag):
        shape = list(p.shape)
        if flag >= 0:
            shape[flag] //= DP
        return jax.numpy.zeros(shape, jax.numpy.float32)

    rank_steps = {}
    for variant, (fields, _) in STEPS.items():
        tcfg = JTrainConfig(opt=jcfg_opt, remat=False, **fields)
        fl = flags if tcfg.zero1 else None

        def one(p, b, tcfg=tcfg, fl=fl):
            state = jopt.adamw_init(p)
            if fl is not None:
                m0 = jax.tree_util.tree_map(zero_moments, p, fl)
                state = {"m": m0, "v": m0, "step": state["step"]}
            _, s, metrics = jmake_step_fn(mdp, tcfg, shard_flags=fl)(p, state, b)
            return s["m"], s["v"], metrics["grad_norm"]

        f = jax.vmap(jax.vmap(one, in_axes=(0, None), axis_name="model"),
                     in_axes=(None, 0), axis_name="data")
        rank_steps[variant] = jax.tree_util.tree_map(np.asarray,
                                                     jax.jit(f)(stacked, by_rank))

    # the collectives' values and transposes, and the compressed all-reduce
    rng = np.random.default_rng(5)
    x = rng.standard_normal((DP, TP, 4, 6)).astype(np.float32)
    x[..., 0, :] *= 1e3  # blocks of unlike scale for int8
    w = rng.standard_normal((4, 12)).astype(np.float32)
    coll = {}
    for name, (_, jfn, shape) in COLLECTIVES.items():
        f = lambda xr, jfn=jfn, shape=shape: (w[:shape[0], :shape[1]] * jfn(xr)).sum()
        vf = jax.vmap(jax.value_and_grad(lambda xr, jfn=jfn: f(xr)), axis_name="model")
        ys = jax.vmap(jfn, axis_name="model")
        coll[name] = [(np.asarray(ys(x[d])), np.asarray(vf(x[d])[1])) for d in range(DP)]
    compress = {mode: [np.asarray(jax.vmap(lambda g, mode=mode: jallreduce(
        {"g": g}, mode, "data")["g"], axis_name="data")(x[:, m])) for m in range(TP)]
        for mode in COMPRESS}

    cases = {"loss": loss_cases, "coll": (torch.from_numpy(x), torch.from_numpy(w)),
             "step": (cfg, params_from_jax(params), params_from_jax(batch))}
    ranks = spmd.run(_ranks, TP * DP, (cases,), timeout=600)
    return {"ranks": ranks, "want_loss": want_loss, "ref_loss": float(loss),
            "ref_params": params_from_jax(new_params), "rank_grads": rank_grads,
            "rank_steps": rank_steps,
            "coll": coll, "compress": compress}


def _coords(r):
    step = r["steps"]["plain"]
    return step["data"], step["model"]


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collective_transposes_equal_jax(run, name):
    """Each rank's output and input gradient of sum(w * collective(x)) equal
    JAX's under ``jax.vmap(axis_name="model")``: a psum's cotangent is
    psummed, an all_gather's psum_scattered, a psum_scatter's all_gathered."""
    for r in run["ranks"]:
        d, m = _coords(r)
        y, g = r["coll"][name]
        want_y, want_g = run["coll"][name][d]
        np.testing.assert_allclose(y.numpy(), want_y[m], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), want_g[m], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", COMPRESS)
def test_compressed_allreduce_equals_jax(run, mode):
    """``allreduce_compressed`` over the data axis, each mode against JAX's
    under ``jax.vmap(axis_name="data")``: the same sums, bf16 roundings and
    agreed int8 scales."""
    for r in run["ranks"]:
        d, m = _coords(r)
        np.testing.assert_allclose(r["compress"][mode].float().numpy(),
                                   np.asarray(run["compress"][mode][m][d], np.float32),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", [*LOSS_ARCHS, "qwen3_4b-sp"])
def test_tp_loss_equals_single_device(run, name):
    want = run["want_loss"][name]
    for r in run["ranks"]:
        assert abs(r["loss"][name] - want) / max(abs(want), 1e-6) < 0.005, (name, r["loss"])


def test_sp_loss_equals_tp_loss(run):
    for r in run["ranks"]:
        np.testing.assert_allclose(r["loss"]["qwen3_4b-sp"], r["loss"]["qwen3_4b"],
                                   rtol=2e-4)


def test_rank_grads_equal_jax_vmap(run):
    """Each rank's local gradients against JAX's for the same (data, model)
    coordinate; no leaf's gradient is zero."""
    for r in run["ranks"]:
        step = r["steps"]["plain"]
        d, m = step["data"], step["model"]
        got = _by_key(step["grads"])
        want = {k: np.asarray(v[m]) for k, v in _jax_by_key(run["rank_grads"][d]).items()}
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k].numpy()
            assert g.shape == w.shape, k
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g, w, rtol=GRAD_TOL["rtol"],
                                       atol=GRAD_TOL["atol"] * scale, err_msg=k)
            assert np.abs(g).max() > 0, k


@pytest.mark.parametrize("variant", list(STEPS))
def test_train_step_matches_single_device(run, variant):
    bound = STEPS[variant][1]
    ref = run["ref_params"]
    specs = param_specs(ref)
    for r in run["ranks"]:
        step = r["steps"][variant]
        loss = step["losses"][0]
        assert abs(loss - run["ref_loss"]) / max(abs(run["ref_loss"]), 1e-6) < 0.02
        want = _by_key(shard_params(ref, specs, step["model"], TP))
        got = _by_key(step["params"])
        assert set(got) == set(want)
        worst = max(float((got[k] - want[k]).abs().max()) for k in want)
        assert worst < bound, (variant, worst)


@pytest.mark.parametrize("variant", list(STEPS))
def test_train_step_moments_equal_jax_vmap(run, variant):
    """Each rank's first-step moments ``m`` and ``v`` and its gradient norm
    against JAX's ``make_step_fn`` on the same (data, model) coordinate,
    under ``jax.vmap`` over both axes, at the gradient tolerance (each
    leaf's atol scaled by its max).  The moments are the data-axis mean of
    the local gradients, clipped: a dropped data-axis reduction, a missing
    ``/ dp``, a wrong ZeRO-1 scatter or clip each move them by a factor
    (a ``/ dp`` lost ahead of an active clip cancels in them, and doubles
    the norm).  int8 allows INT8_FLIPS."""
    jm, jv, jn = run["rank_steps"][variant]
    for r in run["ranks"]:
        step = r["steps"][variant]
        d, m = step["data"], step["model"]
        np.testing.assert_allclose(step["metrics"][0]["grad_norm"], float(jn[d, m]),
                                   rtol=GRAD_TOL["rtol"])
        for name, tree in (("m", jm), ("v", jv)):
            got = _by_key(step["opt"][name])
            want = {k: v[d, m] for k, v in _jax_by_key(tree).items()}
            assert set(got) == set(want), name
            for k, w in want.items():
                g = got[k].numpy()
                assert g.shape == w.shape, (name, k)
                scale = max(float(np.abs(w).max()), 1e-30)
                if variant == "int8":
                    off = ~np.isclose(g, w, rtol=GRAD_TOL["rtol"],
                                      atol=GRAD_TOL["atol"] * scale)
                    assert off.mean() <= INT8_FLIPS[0], (name, k, off.sum())
                    assert np.abs(g - w)[off].max(initial=0) <= INT8_FLIPS[1] * scale, (name, k)
                    continue
                np.testing.assert_allclose(g, w, rtol=GRAD_TOL["rtol"],
                                           atol=GRAD_TOL["atol"] * scale,
                                           err_msg=f"{variant} {name} {k}")
