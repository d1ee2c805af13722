"""dp-grad in the port: the data-parallel gradient-sync contract traced
through ``torch.autograd`` and verified.

* ``repro_torch::dot_general``'s autograd rule against ``jax.vjp`` of
  ``lax.dot_general`` over the dimension numbers the zoo's products use, in
  numbers and in the traced IR (the backward's products are ``dot`` nodes
  with lax's transposed dimension numbers);
* the traced gradient programs run on real inputs: the base program, and
  the per-rank program (``spmd.dp_grad``) traced and run on two gloo CPU
  ranks, against the trainer's eager autograd path and ``jax.grad`` of the
  JAX forward sum, at ``test_loss_and_grads_equal_jax``'s tolerances;
* the verdict for the five dense archs at dp 2 and dp 4 (full width, 2
  layers, seq 8: the JAX package's own ``Plan.grad`` case, whose verdict
  fails on this toolchain's jax, which emits ``split``);
* faults: the gradient psum dropped (``drop_all_reduce``; the injected site
  is ``spmd.dp_grad``'s ``psum_dp`` line) and a transpose of the backward
  pass swapped (``wrong_transpose``), each detected and localized.
"""
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.trace import trace as jtrace  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.inject import drop_all_reduce, wrong_transpose  # noqa: E402
from repro_torch.core.trace import ShapeDtype, fx_program, trace  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_leaves  # noqa: E402
from repro_torch.verify import Plan, Session  # noqa: E402
from repro_torch.verify.campaign import _localized  # noqa: E402

# test_torch_train.py's tolerances (tests/test_kernels.py:16-17), a
# gradient leaf's atol scaled by its largest entry
TOL = dict(rtol=2e-4, atol=2e-4)
DENSE = ["llama3_8b", "qwen3_4b", "qwen1_5_4b", "chatglm3_6b", "gemma_2b"]
DP = 2
B, S = 2, 8


def _dg(lhs, rhs, lc, rc, lb, rb, f32):
    from repro_torch.core.trace import _dot_general

    return _dot_general(lhs, rhs, list(lc), list(rc), list(lb), list(rb), f32)


# (lhs shape, rhs shape, ((lc, rc), (lb, rb))): x @ w, the attention scores
# and values of chunked_attention, the SSD scan's two-dim contraction
DOTS = {
    "matmul": ((2, 8, 16), (16, 4), (((2,), (0,)), ((), ()))),
    "scores": ((2, 2, 3, 8, 16), (2, 2, 5, 16), (((4,), (3,)), ((0, 1), (0, 1)))),
    "values": ((2, 2, 3, 8, 5), (2, 2, 5, 16), (((4,), (2,)), ((0, 1), (0, 1)))),
    "rhs_first": ((2, 6, 4), (2, 3, 6), (((1,), (2,)), ((0,), (0,)))),
    "two_dims": ((3, 4, 5, 2), (4, 5, 7), (((1, 2), (0, 1)), ((), ()))),
}


@pytest.mark.parametrize("f32", [False, True], ids=["same_dtype", "f32"])
@pytest.mark.parametrize("name", list(DOTS))
def test_dot_general_vjp_equals_jax(name, f32):
    """Both cotangents equal ``jax.vjp``'s, and the traced backward is
    ``dot`` nodes with the dimension numbers lax's transpose rules give
    (``f32``: bf16 operands accumulated in float32, each cotangent
    converted back to bf16)."""
    ls, rs, ((lc, rc), (lb, rb)) = DOTS[name]
    rng = np.random.default_rng(0)
    dt, jdt = (torch.bfloat16, jnp.bfloat16) if f32 else (torch.float32, jnp.float32)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in (ls, rs))
    a_t, b_t = (torch.from_numpy(x).to(dt).requires_grad_() for x in (a, b))
    out = _dg(a_t, b_t, lc, rc, lb, rb, f32)
    ct = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    ct_t = torch.from_numpy(ct).to(out.dtype)
    ga, gb = torch.autograd.grad(out, (a_t, b_t), ct_t)

    def jfn(x, y):
        return lax.dot_general(x, y, ((lc, rc), (lb, rb)),
                               preferred_element_type=jnp.float32 if f32 else None)

    jx, jy = (jnp.asarray(x, jdt) for x in (a, b))
    jout, vjp = jax.vjp(jfn, jx, jy)
    assert tuple(out.shape) == jout.shape and str(out.dtype)[6:] == str(jout.dtype)
    want = vjp(jnp.asarray(ct, jout.dtype))
    tol = dict(rtol=1e-2, atol=1e-2) if f32 else TOL
    for got, w in zip((ga, gb), want):
        assert got.dtype == dt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32), **tol)

    def tfn(x, y, g):
        x, y = x.detach().requires_grad_(), y.detach().requires_grad_()
        return list(torch.autograd.grad(_dg(x, y, lc, rc, lb, rb, f32), (x, y), g))

    shapes = [ShapeDtype(ls, dt), ShapeDtype(rs, dt), ShapeDtype(tuple(out.shape), out.dtype)]
    g, _, _ = trace(tfn, *shapes, grad=True)
    jg, _, _ = jtrace(lambda x, y, c: jax.vjp(jfn, x, y)[1](c), *[
        jax.ShapeDtypeStruct(s.shape, jnp.bfloat16 if s.dtype == torch.bfloat16
                             else jnp.float32) for s in shapes])

    def dots(gr):
        return [tuple(tuple(map(tuple, d)) for d in n.param("dimension_numbers"))
                for n in gr if n.op == "dot"]
    # JAX's trace keeps the forward product, which make_fx drops as dead
    assert sorted(dots(g)) == sorted(dots(jg)[1:])
    body = {n.op for n in g if n.op not in ("input", "const")}
    assert body <= {"dot", "transpose", "convert"}


def _jax_case(arch):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), n_layers=2, dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True), n_layers=2, dtype="float32")
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    want = jax.jit(jax.grad(lambda p: jm.forward(p, {"tokens": tokens}, unroll=True)
                            .astype(jnp.float32).sum()))(params)
    return cfg, params_from_jax(params), torch.from_numpy(tokens.astype(np.int64)), want


def _by_key(tree):
    return {"/".join(map(str, path)): leaf for path, leaf in tree_flatten_with_path(tree)[0]}


def _jax_by_key(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in flat}


def _close(got, want, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=TOL["atol"] * scale,
                               err_msg=what)


def _dist_ranks(rank, world, cases):
    """On each gloo rank: ``spmd.dp_grad`` traced (the verifier's gradient
    path, under this rank's process group), then run on the rank's rows."""
    from repro_torch.parallel.ctx import ParallelCtx

    out = {}
    for arch, (cfg, params, tokens) in cases.items():
        model = Model(cfg, ParallelCtx(dp_axis=("data",), dp_size=world),
                      impl="reference", device="cpu")
        rows = tokens.shape[0] // world
        batch = {"tokens": tokens[rank * rows:(rank + 1) * rows]}
        gm = fx_program(lambda p, bb: spmd.dp_grad(model, p, bb), params, batch, grad=True)
        leaves = gm(*tree_leaves((params, batch)))
        out[arch] = {"traced": leaves, "eager": tree_leaves(spmd.dp_grad(model, params,
                                                                         batch))}
    return out


@pytest.fixture(scope="module")
def grad_cases():
    return {arch: _jax_case(arch) for arch in ("qwen3_4b", "llama3_8b")}


@pytest.fixture(scope="module")
def dist_grads(grad_cases):
    cases = {a: (cfg, p, t) for a, (cfg, p, t, _) in grad_cases.items()}
    return spmd.run(_dist_ranks, DP, (cases,), timeout=600)


@pytest.mark.parametrize("arch", ["qwen3_4b", "llama3_8b"])
def test_traced_grads_equal_eager_and_jax(arch, grad_cases, dist_grads):
    """The base program as traced, run on real inputs, the trainer's eager
    autograd path (``spmd.sum_grads``), and each DP rank's traced and eager
    ``spmd.dp_grad`` (its rows' gradients psummed over two gloo ranks) all
    give JAX's full-batch gradients of the forward sum."""
    cfg, params, tokens, want = grad_cases[arch]
    model = Model(cfg, impl="reference", device="cpu")
    batch = {"tokens": tokens}
    gm = fx_program(lambda p, bb: spmd.sum_grads(model, p, bb), params, batch, grad=True)
    keys = list(_by_key(params))
    traced = dict(zip(keys, gm(*tree_leaves((params, batch)))))
    eager = _by_key(spmd.sum_grads(model, params, batch))
    jwant = _jax_by_key(want)
    assert set(jwant) == set(keys)
    for k in keys:
        _close(traced[k], jwant[k], f"{arch} traced base {k}")
        _close(eager[k], jwant[k], f"{arch} eager {k}")
        for r, ranks in enumerate(dist_grads):
            d = dict(zip(keys, ranks[arch]["traced"]))
            e = dict(zip(keys, ranks[arch]["eager"]))
            _close(d[k], jwant[k], f"{arch} rank {r} traced dp_grad {k}")
            _close(e[k], jwant[k], f"{arch} rank {r} eager dp_grad {k}")


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", [*DENSE, "mamba2_130m"])
def test_grad_plan_verifies(arch, dp):
    """mamba2_130m's pair verifies since its lookup traces as ``jnp.take``
    (one filling gather, its transpose one dropping scatter_add): the NaN
    fill's select on a zero broadcast had let its fact come seventh, past
    the select rule's six."""
    with Session() as s:
        rep = s.verify(arch, Plan.grad(dp=dp, layers=2, seq=8))
    assert rep.verified, rep.summary()
    assert [x["scenario"] for x in rep.scenarios] == ["dp-grad"]


def _psum_dp_line() -> str:
    lines, first = inspect.getsourcelines(spmd.dp_grad)
    i = next(i for i, ln in enumerate(lines) if "psum_dp" in ln and "return" in ln)
    return f"spmd.py:{first + i}"


@pytest.mark.parametrize("arch", ["llama3_8b", "qwen3_4b"])
def test_grad_faults_detected_and_localized(arch):
    """A dropped gradient psum fails the pair: the injected site is the
    ``psum_dp`` line of ``spmd.dp_grad`` and the verifier names a missing
    all_reduce on an output; a transpose of the backward pass swapped
    fails it at that transpose's model line (the forward op's, which the
    backward node takes)."""
    plan = Plan.grad(dp=DP, layers=2, seq=8)
    held = {}

    def drop(gd):
        held["drop"] = drop_all_reduce(gd, index=1)
        return held["drop"].graph

    def swap(gd):
        sites, n = [], 0
        while (inj := wrong_transpose(gd, index=n)) is not None:
            sites.append(inj.site)
            n += 1
        # the last transpose at chunked_attention's K/V chunking: the
        # forward's come first, so this is one of its cotangent's
        last = max(i for i, s in enumerate(sites) if s.startswith("attention.py"))
        assert sites.count(sites[last]) > 1
        held["swap"] = wrong_transpose(gd, index=last)
        return held["swap"].graph

    with Session() as s:
        assert s.verify(arch, plan).verified
        bad = s.verify(arch, plan, mutate_dist=drop)
        swapped = s.verify(arch, plan, mutate_dist=swap)
    assert not bad.verified
    assert held["drop"].site == _psum_dp_line()
    assert _localized(bad, held["drop"]) == (True, True)
    assert bad.bug_sites[0].category == "missing_all_reduce"
    assert not swapped.verified
    site = held["swap"].site
    assert site.startswith("attention.py:")
    assert _localized(swapped, held["swap"])[0]
    assert any(b.src == site for b in swapped.bug_sites[:3])
