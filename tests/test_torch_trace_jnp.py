"""The port's tracer against the JAX package's on the same small functions:
the torch op and its ``jax.numpy`` counterpart lower to the same IR ops, with
the same parameters where the rules read them.  The cases are GeGLU's tanh
``F.gelu``, the ops of the SSM layers (``F.pad``, ``F.softplus``,
``torch.cumsum``, ``torch.stack``, einsums over three operands, whose
contraction order depends on the shapes),
the decode step's cache write (``index_copy_`` at a wrapped and clamped
index, traced functionalized), the sequence-parallel collectives, the
frontends' prefix (``x @ w + b`` concatenated with token embeddings) and
their entry into the SP region (``dynamic_slice_in_dim`` at ``rank *
chunk``), and the ATen spellings of a matmul, ``x[:, None]``, a unit-dim
index, an f32 product of bf16 operands and ``c / x``."""
import jax
import numpy as np
import jax.numpy as jnp
import pytest
from jax import lax
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro.compat import abstract_mesh  # noqa: E402
from repro.core.trace import trace as jtrace  # noqa: E402
from repro.core.trace import trace_sharded as jtrace_sharded  # noqa: E402
from repro_torch.core.trace import ShapeDtype, fx_program, trace, trace_sharded  # noqa: E402
from repro_torch.models.attention import write_index  # noqa: E402
from repro_torch.models.modules import dynamic_slice_in_dim, einsum_f32, take  # noqa: E402
from repro_torch.parallel.sharding import P  # noqa: E402

F32 = (torch.float32, jnp.float32)
BF16 = (torch.bfloat16, jnp.bfloat16)


def _body(g):
    return [n.op for n in g if n.op not in ("input", "const")]


def _pair(tfn, jfn, *shapes):
    """(torch graph, JAX graph) of ``tfn`` and ``jfn`` over ``shapes``, each
    a (shape, (torch dtype, jnp dtype))."""
    g, _, _ = trace(tfn, *[ShapeDtype(s, d[0]) for s, d in shapes])
    jg, _, _ = jtrace(jfn, *[jax.ShapeDtypeStruct(s, d[1]) for s, d in shapes])
    return g, jg


def _param(g, op, key):
    return [n.param(key) for n in g if n.op == op]


def test_softplus_is_logaddexp():
    g, jg = _pair(F.softplus, jax.nn.softplus, ((2, 5), F32))
    assert _body(g) == _body(jg)
    sel = next(n for n in g if n.op == "select")
    jsel = next(n for n in jg if n.op == "select")
    assert [g[i].op for i in sel.inputs] == [jg[i].op for i in jsel.inputs]


@pytest.mark.parametrize("dtypes", [F32, BF16], ids=["f32", "bf16"])
def test_tanh_gelu_is_jax_gelu(dtypes):
    """GeGLU's ``F.gelu(approximate="tanh")`` lowers as ``jax.nn.gelu``:
    x**3, * 0.044715, + x, * sqrt(2/pi), tanh, + 1, * 0.5, * x, with the
    constants in x's dtype and each operand where jnp puts it."""
    g, jg = _pair(lambda x: F.gelu(x, approximate="tanh"), jax.nn.gelu, ((2, 5), dtypes))
    assert _body(g) == _body(jg) == ["integer_pow", "mul", "add", "mul", "tanh", "add",
                                     "mul", "mul"]
    assert [[g[i].op for i in n.inputs] for n in g] == [[jg[i].op for i in n.inputs]
                                                         for n in jg]
    assert {n.dtype for n in g} == {n.dtype for n in jg} == {str(dtypes[1].dtype)}
    assert _param(g, "integer_pow", "y") == [3]
    # the exact form stays opaque: the reference has no lowering to hold it to
    ge, _, _ = trace(F.gelu, ShapeDtype((2, 5), torch.float32))
    assert _body(ge) == ["gelu"]


def test_causal_pad_is_one_pad():
    g, jg = _pair(lambda x: F.pad(x, (0, 0, 3, 0)),
                  lambda x: jnp.pad(x, ((0, 0), (3, 0), (0, 0))), ((2, 6, 4), BF16))
    # jnp.pad's constant 0 is a weakly typed int: converted, then the pad
    assert _body(g) == _body(jg) == ["convert", "pad"]
    assert _param(g, "convert", "new_dtype") == _param(jg, "convert", "new_dtype")
    assert _param(g, "pad", "padding_config") == [((0, 0, 0), (3, 0, 0), (0, 0, 0))]
    assert [tuple(map(tuple, c)) for c in _param(jg, "pad", "padding_config")] == \
        _param(g, "pad", "padding_config")


def test_cumsum_and_stack():
    g, jg = _pair(lambda x: torch.stack([x.cumsum(-1), x]).permute(1, 0, 2),
                  lambda x: jnp.stack([jnp.cumsum(x, axis=-1), x]).transpose(1, 0, 2),
                  ((3, 4), F32))
    assert _body(g) == _body(jg) == ["cumsum", "broadcast", "broadcast", "concat",
                                     "transpose"]
    assert _param(g, "cumsum", "axis") == _param(jg, "cumsum", "axis") == [1]


# ATen spellings that jnp writes as one op (or as none): a 3-D activation
# times a matrix, x[:, None] and x[:, None, None], indexing a unit dim, the
# f32 product of bf16 operands, c / x
@pytest.mark.parametrize("tfn,jfn,shapes", [
    (lambda x, w: x @ w, lambda x, w: x @ w, [((2, 8, 16), BF16), ((16, 4), BF16)]),
    (lambda x: x[:, None] * 2, lambda x: x[:, None] * 2, [((3, 4), F32)]),
    (lambda x: x[:, :, None, None] * 2, lambda x: x[:, :, None, None] * 2, [((3, 4), F32)]),
    (lambda x: x[:, 0] * 2, lambda x: x[:, 0] * 2, [((3, 1, 4), F32)]),
    (lambda q, k: einsum_f32("bqd,bkd->bqk", q, k),
     lambda q, k: jnp.einsum("bqd,bkd->bqk", q, k, preferred_element_type=jnp.float32),
     [((2, 8, 16), BF16), ((2, 4, 16), BF16)]),
    (lambda x: 1.0 / (x + 2), lambda x: 1.0 / (x + 2), [((4,), F32)]),
], ids=["matmul", "expand_dims", "expand_dims2", "index_unit_dim", "preferred_f32",
        "rdiv"])
def test_jnp_spellings_trace_as_jnp(tfn, jfn, shapes):
    g, jg = _pair(tfn, jfn, *shapes)
    assert _body(g) == _body(jg)
    for op, key in (("dot", "dimension_numbers"), ("broadcast", "broadcast_dimensions"),
                    ("slice", "start_indices"), ("slice", "limit_indices")):
        assert _param(g, op, key) == [_freeze(v) for v in _param(jg, op, key)]
    assert [(n.op, n.dtype) for n in g if n.op not in ("input", "const")] == \
        [(n.op, n.dtype) for n in jg if n.op not in ("input", "const")]


def _freeze(v):
    return tuple(_freeze(x) for x in v) if isinstance(v, (list, tuple)) else v


# the SSD scan's and the SSM decode step's three-operand einsums, at SMOKE
# and full-width sizes (P, N): opt_einsum's order differs between the two
@pytest.mark.parametrize("P_,N", [(32, 16), (64, 128)])
@pytest.mark.parametrize("eq,dims", [
    ("bckn,bckh,bckhp->bchpn", "bckn,bckh,bckhp"),
    ("bcqn,bchpn,bcqh->bcqhp", "bcqn,bchpn,bcqh"),
    ("bh,bn,bhp->bhpn", "bh,bn,bhp"),
    ("bchqk,bckhp->bcqhp", "bchqk,bckhp"),
    ("bkc,kc->bc", "bkc,kc"),
])
def test_einsum_follows_jnp_contraction_order(eq, dims, P_, N):
    size = dict(b=2, c=2, k=8, q=8, h=3, p=P_, n=N)
    shapes = [(tuple(size[c] for c in t), F32) for t in dims.split(",")]
    g, jg = _pair(lambda *a: torch.einsum(eq, *a), lambda *a: jnp.einsum(eq, *a), *shapes)
    assert _body(g) == _body(jg)
    assert _param(g, "dot", "dimension_numbers") == _param(jg, "dot", "dimension_numbers")
    assert _param(g, "transpose", "permutation") == _param(jg, "transpose", "permutation")
    assert [n.shape for n in g if n.op == "dot"] == [n.shape for n in jg if n.op == "dot"]


def test_cache_write_is_dynamic_update_slice():
    """``index_copy_`` of one slot at ``write_index(position)`` traces, in a
    functionalized step, to ``dynamic_update_slice`` at the wrapped index,
    with the written buffer as the output; two writes at one index each
    wrap it, and neither clamps (the op does), as two
    ``lax.dynamic_update_slice_in_dim`` calls trace."""
    def step(k, v, new, pos):
        w = write_index(pos, k.shape[2])[None]
        k.index_copy_(2, w, new)
        v.index_copy_(2, w, new * 2)
        return k * 1, v

    def jstep(k, v, u, p):
        return (lax.dynamic_update_slice_in_dim(k, u, p, axis=2) * 1,
                lax.dynamic_update_slice_in_dim(v, u * 2, p, axis=2))

    buf, upd = (2, 4, 8, 3), (2, 4, 1, 3)
    g, ins, outs = trace(step, ShapeDtype(buf, torch.bfloat16), ShapeDtype(buf, torch.bfloat16),
                         ShapeDtype(upd, torch.bfloat16), ShapeDtype((), torch.int64))
    jg, _, _ = jtrace(jstep, jax.ShapeDtypeStruct(buf, jnp.bfloat16),
                      jax.ShapeDtypeStruct(buf, jnp.bfloat16),
                      jax.ShapeDtypeStruct(upd, jnp.bfloat16),
                      jax.ShapeDtypeStruct((), jnp.int32))
    assert sorted(_body(g)) == sorted(_body(jg))
    dus = [n for n in g if n.op == "dynamic_update_slice"]
    assert [list(n.inputs[:1]) for n in dus] == [ins[:1], ins[1:2]]
    starts = [g[n.inputs[4]] for n in dus]
    assert [n.op for n in starts] == ["select", "select"] and starts[0].id != starts[1].id
    assert len(outs) == 2


def test_written_stacked_buffers_become_outputs():
    """A step that writes each slot of a stacked buffer in place returns
    ``stack`` of the slot values, as the JAX step returns the new caches;
    reads after a write see the written value, not the input."""
    def step(buf, x):
        for i in range(buf.shape[0]):
            buf[i].copy_(buf[i] * 2 + x)
            x = buf[i].sum(0)  # read back after the write
        return x, buf

    g, ins, outs = trace(step, ShapeDtype((3, 4, 5), torch.float32),
                         ShapeDtype((5,), torch.float32))
    assert [g[o].op for o in outs] == ["reduce_sum", "concat"]
    assert "copy_" not in _body(g) and "select_scatter" not in _body(g)
    assert g[outs[1]].shape == (3, 4, 5)
    assert len([n for n in g if n.op == "mul"]) == 3  # one write a slot, no copy


def test_sequence_parallel_collectives_follow_lax():
    """``sp_enter``/``sp_exit`` of a sequence-parallel context trace to one
    reduce_scatter and one all_gather along the sequence, as
    ``lax.psum_scatter``/``lax.all_gather`` with ``tiled=True``."""
    from repro_torch.parallel.ctx import ParallelCtx

    def tfn(ctx, x):
        sp = ParallelCtx.tensor_parallel(4, rank=ctx.rank, sp=True)
        return sp.sp_exit(sp.sp_enter(x) * 2)

    g, _, _ = trace_sharded(tfn, 4, (P(),), ShapeDtype((2, 8, 3), torch.float32))
    mesh = abstract_mesh((4,), ("model",))
    jg, _, _ = jtrace_sharded(
        lambda x: lax.all_gather(lax.psum_scatter(x, "model", scatter_dimension=1,
                                                  tiled=True) * 2,
                                 "model", axis=1, tiled=True),
        mesh, (JP(),), JP(), jax.ShapeDtypeStruct((2, 8, 3), jnp.float32))
    assert _body(g) == _body(jg) == ["reduce_scatter", "mul", "all_gather"]
    assert _param(g, "reduce_scatter", "scatter_dimension") == [1]
    assert _param(g, "all_gather", "all_gather_dimension") == [1]
    for op, key in (("reduce_scatter", "scatter_dimension"),
                    ("all_gather", "all_gather_dimension")):
        assert _param(g, op, key) == _param(jg, op, key)


def test_frontend_prefix_and_sp_slice_follow_lax():
    """A projected patch prefix (``x @ w + b``) concatenated with token
    embeddings along the sequence, then this rank's chunk of it, as the
    frontends enter the SP region: one ``concat`` and
    ``lax.dynamic_slice_in_dim``'s IR, the ``axis_index * chunk`` start on
    axis 1 after jnp's wrap (``select(s < 0, s, s + n)``), constant zeros
    on the other axes."""
    def tfn(ctx, v, w, b, t):
        x = torch.cat([v @ w + b, t], dim=1)
        chunk = x.shape[1] // 4
        return dynamic_slice_in_dim(x, ctx.rank * chunk, chunk, axis=1) * 2

    def jfn(v, w, b, t):
        x = jnp.concatenate([v @ w + b, t], axis=1)
        chunk = x.shape[1] // 4
        return lax.dynamic_slice_in_dim(x, lax.axis_index("model") * chunk, chunk, axis=1) * 2

    shapes = [(2, 4, 6), (6, 8), (8,), (2, 12, 8)]
    g, _, _ = trace_sharded(tfn, 4, (P(),) * 4,
                            *[ShapeDtype(s, torch.bfloat16) for s in shapes])
    jg, _, _ = jtrace_sharded(jfn, abstract_mesh((4,), ("model",)), (JP(),) * 4, JP(),
                              *[jax.ShapeDtypeStruct(s, jnp.bfloat16) for s in shapes])
    assert _body(g) == _body(jg) == ["dot", "broadcast", "add", "concat", "axis_index", "mul",
                                     "lt", "add", "select", "dynamic_slice", "mul"]
    assert _param(g, "concat", "dimension") == _param(jg, "concat", "dimension") == [1]
    assert _param(g, "dynamic_slice", "slice_sizes") == [(2, 4, 8)]
    assert _param(jg, "dynamic_slice", "slice_sizes") == [(2, 4, 8)]

    def starts(graph):
        ds = next(n for n in graph if n.op == "dynamic_slice")
        out = []
        for i in ds.inputs[1:]:
            n = graph[i]
            if n.op == "const":
                out.append(("const", n.param("value")))
            else:  # select(lt(s, 0), s, s + n) over s = axis_index * chunk
                pred, s, wrapped = (graph[j] for j in n.inputs)
                out.append((n.op, pred.op, s.op, [graph[j].op for j in s.inputs],
                            [graph[j].param("value") for j in s.inputs
                             if graph[j].op == "const"], wrapped.op,
                            [graph[j].param("value") for j in wrapped.inputs
                             if graph[j].op == "const"]))
        return out

    assert starts(g) == starts(jg) == [
        ("const", 0), ("select", "lt", "mul", ["axis_index", "const"], [4], "add", [16]),
        ("const", 0)]


@pytest.mark.parametrize("start", [-5, 0, 3, 9, 40])  # wraps once; clamps past the end
def test_dynamic_slice_matches_lax(start):
    x = np.arange(2 * 12 * 3, dtype=np.float32).reshape(2, 12, 3)
    got = dynamic_slice_in_dim(torch.from_numpy(x), torch.tensor(start), 4, axis=1)
    want = lax.dynamic_slice_in_dim(jnp.asarray(x), jnp.int32(start), 4, axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the MoE router's ops ------------------------------------------------------


def test_top_k_is_one_node_each_output():
    """``mlp.top_k`` (a stable descending sort, ties to the lower index)
    traces as ``lax.top_k``: one ``top_k`` node for the values and one for
    the indices, each with the axis and ``k``."""
    from repro_torch.models.mlp import top_k

    g, jg = _pair(lambda x: top_k(x, 2), lambda x: lax.top_k(x, 2), ((6, 5), F32))
    assert _body(g) == _body(jg) == ["top_k", "top_k"]
    assert [n.shape for n in g if n.op == "top_k"] == [(6, 2), (6, 2)]
    assert [(n.param("axis"), n.param("k")) for n in g if n.op == "top_k"] == \
        [(n.param("axis"), n.param("k")) for n in jg if n.op == "top_k"] == [(1, 2)] * 2
    assert [n.dtype for n in g if n.op == "top_k"] == ["float32", "int64"]


def test_softmax_is_jax_softmax():
    """``torch.softmax`` traces as ``jax.nn.softmax``: the row max floored
    at -inf, kept dims back, ``stop_gradient`` (a ``copy``), then exp, sum
    and div."""
    g, jg = _pair(lambda x: torch.softmax(x, dim=-1), lambda x: jax.nn.softmax(x, axis=-1),
                  ((3, 4), F32))
    assert _body(g) == _body(jg) == ["reduce_max", "max", "broadcast", "copy", "sub",
                                     "exp", "reduce_sum", "broadcast", "div"]
    assert [[g[i].op for i in n.inputs] for n in g] == [[jg[i].op for i in n.inputs]
                                                         for n in jg]


def test_router_scatter_add_is_jnp_at_add():
    """The dense router mask, ``zeros.index_put((tok, idx), w,
    accumulate=True)`` with ``tok = arange(T)[:, None].repeat(1, K)``,
    traces as ``zeros.at[tok, idx].add(w)`` with ``jnp.repeat``: each index
    wrapped once, given a unit dim and concatenated, one ``scatter_add``."""
    T, E, K = 6, 5, 2

    def tfn(w, idx):
        tok = torch.arange(T)[:, None].repeat(1, K)
        z = torch.zeros((T, E), dtype=torch.float32)
        return z.index_put((tok.reshape(-1), idx.reshape(-1)), w.reshape(-1),
                           accumulate=True)

    def jfn(w, idx):
        tok = jnp.arange(T)[:, None].repeat(K, 1)
        z = jnp.zeros((T, E), jnp.float32)
        return z.at[tok.reshape(-1), idx.reshape(-1)].add(w.reshape(-1))

    g, _, _ = trace(tfn, ShapeDtype((T, K), torch.float32), ShapeDtype((T, K), torch.int64))
    jg, _, _ = jtrace(jfn, jax.ShapeDtypeStruct((T, K), jnp.float32),
                      jax.ShapeDtypeStruct((T, K), jnp.int32))
    assert _body(g) == _body(jg)
    assert [[g[i].op for i in n.inputs] for n in g] == [[jg[i].op for i in n.inputs]
                                                         for n in jg]
    sa, jsa = (next(n for n in h if n.op == "scatter_add") for h in (g, jg))
    for key in ("dimension_numbers", "indices_are_sorted", "unique_indices"):
        assert sa.param(key) == jsa.param(key)
    assert _param(g, "broadcast", "broadcast_dimensions") == \
        [_freeze(v) for v in _param(jg, "broadcast", "broadcast_dimensions")]
    # the wraps add each index's own dim: T for the tokens, E for the experts
    adds = [n for n in g if n.op == "add"]
    assert [g[n.inputs[1]].param("value") for n in adds] == [T, E]


def test_two_axis_collectives_and_ranks_follow_lax():
    """Over a ``{"data": 2, "model": 4}`` mesh each collective carries the
    axis of the group it runs on, each rank read is one ``axis_index`` over
    its axis, and each input is cut by both axes, as ``shard_map`` over
    ``abstract_mesh((2, 4), ("data", "model"))`` traces."""
    def tfn(ctx, x, w):
        y = ctx.psum_tp(x @ w) * ctx.tp_index()
        return ctx.psum_dp(y) + ctx.axis_index("data")

    def jfn(x, w):
        y = lax.psum(x @ w, "model") * lax.axis_index("model")
        return lax.psum(y, ("data",)) + lax.axis_index("data")

    shapes = [(4, 8), (8, 6)]
    g, g_in, _ = trace_sharded(tfn, {"data": 2, "model": 4}, (P("data", "model"), P("model")),
                               *[ShapeDtype(s, torch.float32) for s in shapes])
    jg, jg_in, _ = jtrace_sharded(jfn, abstract_mesh((2, 4), ("data", "model")),
                                  (JP("data", "model"), JP("model")), JP("data"),
                                  *[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])
    assert _body(g) == _body(jg)
    for op in ("all_reduce", "axis_index"):
        assert _param(g, op, "axes") == _param(jg, op, "axes")
    assert _param(g, "all_reduce", "axes") == [("model",), ("data",)]
    assert [g[i].shape for i in g_in] == [jg[i].shape for i in jg_in] == [(2, 2), (2, 6)]


def test_tpdp_program_ir_follows_jax():
    """The composite's 2-D program (SMOKE llama3_8b, tp 2 x dp 2) against
    the JAX trace of the same program: live ops up to ``EMBED_DIFF``'s dist
    difference, the collectives in order with their axes (the model axis
    only: the forward reduces nothing over the data axis), one
    ``axis_index`` over "model" for the embedding and none over "data" (no
    op reads the data rank), and the per-rank input shapes."""
    from repro.verify import Plan as JPlan
    from repro.verify.scenarios import build_pair as jbuild_pair
    from repro_torch.verify import Plan
    from repro_torch.verify.scenarios import build_pair
    from test_torch_verify import EMBED_DIFF, _live_ops

    plan = Plan(tp=2, dp=2, composite=True, smoke=True)
    jplan = JPlan(tp=2, dp=2, composite=True, smoke=True)
    g = build_pair("llama3_8b", plan, plan.scenarios()[1], stamp=False)
    jg = jbuild_pair("llama3_8b", jplan, jplan.scenarios()[1], stamp=False)
    t, j = _live_ops(g.dist), _live_ops(jg.dist)
    assert {op: t[op] - j[op] for op in t | j if t[op] != j[op]} == EMBED_DIFF["dist"]

    def collectives(graph):
        live = graph.toposort(graph.outputs)
        return [(graph[i].op, graph[i].param("axes")) for i in live
                if graph[i].op in ("all_reduce", "all_gather", "reduce_scatter",
                                   "axis_index")]

    assert collectives(g.dist) == collectives(jg.dist)
    assert {axes for _, axes in collectives(g.dist)} == {("model",)}
    assert [g.dist[i].shape for i in g.dist_inputs] == [jg.dist[i].shape
                                                        for i in jg.dist_inputs]
    assert g.dist[g.dist_inputs[-1]].shape == (2, 32)  # tokens (4, 32) over "data"


# the gradient path: each backward op lowers as JAX transposes its forward
# op (the same ops, counted over the nodes the gradient depends on; make_fx
# drops dead code, JAX's trace keeps it)
def _live_ops(g):
    seen, todo = set(), list(g.outputs)
    while todo:
        i = todo.pop()
        if i not in seen:
            seen.add(i)
            todo.extend(g[i].inputs)
    return [g[i] for i in sorted(seen) if g[i].op not in ("input", "const")]


def _grad_pair(tfn, jfn, shape):
    def tgrad(x):
        x = x.detach().requires_grad_()
        return torch.autograd.grad(tfn(x).sum(), x)[0]

    g, _, _ = trace(tgrad, ShapeDtype(shape, torch.float32), grad=True)
    jg, _, _ = jtrace(jax.grad(lambda x: jfn(x).sum()), jax.ShapeDtypeStruct(shape, jnp.float32))
    return g, jg


@pytest.mark.parametrize("tfn,jfn", [
    (lambda x: x[1] * 2, lambda x: x[1] * 2),                  # select_backward
    (lambda x: x[..., :2] * 3, lambda x: x[..., :2] * 3),      # slice_backward
    (F.silu, jax.nn.silu),                                      # silu_backward
    (lambda x: F.gelu(x, approximate="tanh"), jax.nn.gelu),    # gelu_backward (tanh)
    (F.softplus, jax.nn.softplus),                              # softplus_backward
    (lambda x: torch.cumsum(x, -1) * 2, lambda x: jnp.cumsum(x, -1) * 2),  # flip, cumsum, flip
], ids=["select_backward", "slice_backward", "silu_backward", "gelu_backward",
        "softplus_backward", "reverse_cumsum"])
def test_backward_ops_lower_as_jax_transposes(tfn, jfn):
    import collections

    g, jg = _grad_pair(tfn, jfn, (3, 4, 5))
    ops = collections.Counter(n.op for n in _live_ops(g))
    assert ops == collections.Counter(n.op for n in _live_ops(jg))
    for op, key in (("pad", "padding_config"), ("cumsum", "reverse"), ("cumsum", "axis"),
                    ("integer_pow", "y")):
        assert sorted(_param(g, op, key)) == sorted(_freeze(v) for v in _param(jg, op, key))


def test_embedding_gradient_is_take_transpose():
    """``index_put`` with ``accumulate`` into zeros, the gradient of a row
    lookup, is JAX's transpose of ``jnp.take(table, ids, axis=0)``: the ids
    given a trailing index dim and one ``scatter_add`` with the gather's
    dimension numbers into a zero ``broadcast``."""
    def tgrad(t, ids):
        t = t.detach().requires_grad_()
        return torch.autograd.grad(t[ids].sum(), t)[0]

    g, _, _ = trace(tgrad, ShapeDtype((10, 4), torch.float32),
                    ShapeDtype((2, 3), torch.int64), grad=True)
    jg, _, _ = jtrace(jax.grad(lambda t, ids: jnp.take(t, ids, axis=0).sum()),
                      jax.ShapeDtypeStruct((10, 4), jnp.float32),
                      jax.ShapeDtypeStruct((2, 3), jnp.int32))
    sa, = (n for n in g if n.op == "scatter_add")
    jsa, = (n for n in jg if n.op == "scatter_add")
    assert sa.params == jsa.params and sa.shape == jsa.shape
    assert [(g[i].op, g[i].shape, g[i].param("broadcast_dimensions")) for i in sa.inputs] \
        == [(jg[i].op, jg[i].shape, _freeze(jg[i].param("broadcast_dimensions")))
            for i in jsa.inputs]


def test_take_and_its_gradient_equal_jnp_take():
    """``modules.take`` and its gradient give ``jnp.take(table, ids,
    axis=0)``'s values and ``jax.vjp``'s: a negative id counts from the
    end once, an id out of range gives a row of NaN and adds nothing to
    the table's gradient; repeated ids add up."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((10, 4)).astype(np.float32)
    ids = np.array([[0, 9, -1], [10, -11, 3], [3, 3, 12]])
    cot = rng.standard_normal((3, 3, 4)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_()
    out = take(t, torch.from_numpy(ids))
    grad, = torch.autograd.grad(out, t, torch.from_numpy(cot))
    jout, vjp = jax.vjp(lambda x: jnp.take(x, jnp.asarray(ids), axis=0), jnp.asarray(table))
    jgrad, = vjp(jnp.asarray(cot))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))  # NaN rows too
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6)
    assert np.isnan(out.detach().numpy()[1, :2]).all() and not np.isnan(grad.numpy()).any()


def test_masked_fill_is_jnp_where():
    """``masked_fill`` (the in-place ``masked_fill_`` of ``maximum``'s
    backward, folded to its functional form) lowers as ``jnp.where(mask,
    value, x)``."""
    g, jg = _pair(lambda x, y: x.masked_fill(y > 0, 0.0),
                  lambda x, y: jnp.where(y > 0, 0.0, x), ((3, 4), F32), ((3, 4), F32))
    assert _body(g) == _body(jg)
    sel = next(n for n in g if n.op == "select")
    jsel = next(n for n in jg if n.op == "select")
    assert [g[i].op for i in sel.inputs] == [jg[i].op for i in jsel.inputs]


def test_inplace_write_read_through_a_view_is_refused():
    """An in-place op of a gradient trace folds to its functional form only
    where nothing reads the written memory after it: a view of the tensor
    taken before the write and read after it would keep the old values in
    the folded program, so the trace refuses it.  The same write with no
    late reader folds, and the folded program gives eager's values."""
    def late_view(x):
        y = x * 2
        v = y.view(-1)
        y.masked_fill_(y > 1, 0.0)
        return v + 1

    def no_late_view(x):
        y = x * 2
        y.masked_fill_(y > 1, 0.0)
        return y + 1

    sd = ShapeDtype((3, 4), torch.float32)
    with pytest.raises(NotImplementedError, match="read after it"):
        fx_program(late_view, sd, grad=True)
    gm = fx_program(no_late_view, sd, grad=True)
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(gm(x)[0], no_late_view(x))
