"""The port's tracer (repro_torch.core.trace): make_fx over fake tensors,
lowered into the JAX package's TensorIR vocabulary.

Small functions pin the ATen -> IR table; model traces pin the rank as
``axis_index``, layer tags spaced by LAYER_TAG_STRIDE, non-empty ``src`` on
model nodes, hash-consed constants, stamped == full traces node for node
(as tests/test_stamping.py checks for JAX), the fake process group's
teardown, and the embedding meta rule's exact range check."""
import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.rules import meta  # noqa: E402
from repro_torch.core.stamp import TRACE_PERIODS  # noqa: E402
from repro_torch.core.trace import (LAYER_TAG_STRIDE, ShapeDtype, trace,  # noqa: E402
                                    trace_sharded)
from repro_torch.core.verifier import OutputSpec, verify_graphs, verify_sharded  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel.sharding import P  # noqa: E402
from repro_torch.verify.plan import Plan  # noqa: E402
from repro_torch.verify.scenarios import build_pair  # noqa: E402
from repro_torch.verify.scenarios.harness import BuildCtx, stamped_parts  # noqa: E402
from repro_torch.verify.scenarios.tp import _tp_forward_parts  # noqa: E402

F32, BF16, I64 = torch.float32, torch.bfloat16, torch.int64


def _ops(g):
    return [n.op for n in g if n.op not in ("input", "const")]


def _trace(fn, *shapes):
    g, ins, outs = trace(fn, *[ShapeDtype(s, d) for s, d in shapes])
    return g, ins, outs


# ------------------------------------------------------------- vocabulary
def test_matmul_3d_lowers_to_reshape_dot_reshape():
    """A 3-D activation times a matrix lowers as ``jnp.matmul``: one
    ``dot_general`` over the last dim, without the reshapes ATen puts around
    an ``mm`` of merged rows (the lowering this test was named after); a
    matrix times a matrix stays one ``dot``."""
    g, ins, outs = _trace(lambda x, w: x @ w, ((2, 8, 16), F32), ((16, 4), F32))
    assert _ops(g) == ["dot"]
    dot = next(n for n in g if n.op == "dot")
    assert dot.param("dimension_numbers") == (((2,), (0,)), ((), ()))
    assert g[outs[0]].shape == (2, 8, 4) and g[outs[0]].dtype == "float32"
    g, _, _ = _trace(lambda x, w: torch.matmul(x, w), ((8, 16), F32), ((16, 4), F32))
    assert _ops(g) == ["dot"]


def test_einsum_is_one_dot_general_with_batch_dims():
    g, _, outs = _trace(lambda q, k: torch.einsum("bhgqd,bhkd->bhgqk", q, k),
                        ((2, 3, 2, 8, 16), F32), ((2, 3, 8, 16), F32))
    assert _ops(g) == ["dot"]
    dot = next(n for n in g if n.op == "dot")
    assert dot.param("dimension_numbers") == (((4,), (3,)), ((0, 1), (0, 1)))
    assert dot.shape == (2, 3, 2, 8, 8)


def test_mean_rsqrt_and_scalars_follow_jnp():
    def f(x):
        return x * torch.rsqrt(x.mean(-1, keepdim=True) + 1e-5)

    g, _, _ = _trace(f, ((2, 8, 16), F32))
    assert _ops(g) == ["reduce_sum", "broadcast", "div", "add", "rsqrt", "mul"]
    rs = next(n for n in g if n.op == "reduce_sum")
    assert rs.param("axes") == (2,)
    consts = [n for n in g if n.op == "const"]
    assert {n.dtype for n in consts} == {"float32"}  # 16 and 1e-5, as f32 leaves
    assert all(n.shape == () for n in consts)


def test_silu_clamp_where_and_convert():
    def f(x, ids):
        y = torch.nn.functional.silu(x).to(BF16)
        i = ids.clamp(0, 7)
        return torch.where(i[..., None] > 3, y, torch.full((), float("nan"),
                                                           dtype=BF16)), i

    g, _, outs = _trace(f, ((2, 4, 8), F32), ((2, 4), I64))
    ops = _ops(g)
    assert ops[:3] == ["logistic", "mul", "convert"]
    assert ops[3:5] == ["max", "min"]  # jnp.clip: max(lo, x), then min(hi, .)
    sel = next(n for n in g if n.op == "select")
    pred, on_false, on_true = (g[i] for i in sel.inputs)
    # where(c, a, b) is select(c, b, a), every operand broadcast to the output
    assert pred.shape == on_false.shape == on_true.shape == (2, 4, 8)
    assert g[outs[1]].dtype == "int64"
    assert next(n for n in g if n.op == "convert").param("new_dtype") == "bfloat16"


def test_inplace_softmax_and_opaque_ops():
    def f(x, m):
        m = m.clone()
        m &= x > 0
        return torch.softmax(x, -1), m, torch.nn.functional.gelu(x)

    g, _, _ = _trace(f, ((2, 8), F32), ((2, 8), torch.bool))
    ops = _ops(g)
    assert "and" in ops and "bitwise_and_" not in ops
    assert ["reduce_max", "broadcast", "sub", "exp", "reduce_sum", "broadcast",
            "div"] == [o for o in ops if o in ("reduce_max", "broadcast", "sub", "exp",
                                              "reduce_sum", "div")]
    gelu = next(n for n in g if n.op == "gelu")  # no IR op: opaque, named after it
    assert "aten.gelu" in gelu.param("target")


@pytest.mark.parametrize("op", ["and", "or", "xor"])
def test_inplace_operators_trace_as_their_functional_op(op):
    """``m &= x``, ``|=`` and ``^=`` trace (functionalized) to the IR's
    elementwise op, as ``m = m & x`` does."""
    def f(x, m):
        m = m.clone()
        getattr(m, f"__i{op}__")(x > 0)
        return m

    g, _, _ = _trace(f, ((2, 8), F32), ((2, 8), torch.bool))
    assert _ops(g)[-1] == op and not any(o.endswith("_") for o in _ops(g))


def test_scope_is_recorded_only_while_tracing():
    """``named_scope`` nests its path while the tracer preserves node meta,
    and does nothing on the run-time path."""
    import torch.fx.traceback as fx_traceback

    from repro_torch.scope import current_scope, named_scope

    with named_scope("layer1"), named_scope("sub0"):
        assert current_scope() == ""
    with fx_traceback.preserve_node_meta():
        with named_scope("layer1"), named_scope("sub0"):
            assert current_scope() == "layer1/sub0"
        assert current_scope() == ""


def test_select_int_is_slice_plus_reshape():
    g, _, _ = _trace(lambda w: w[1] * 2, ((3, 4, 5), F32))
    assert _ops(g) == ["slice", "reshape", "mul"]
    sl = next(n for n in g if n.op == "slice")
    assert sl.param("start_indices") == (1, 0, 0) and sl.param("limit_indices") == (2, 4, 5)


def test_consts_are_hash_consed():
    g, _, _ = _trace(lambda x, y: (x * 0.5 + 1.0, y * 0.5 + 1.0, x.to(BF16) * 0.5),
                     ((4,), F32), ((4,), F32))
    consts = [(n.shape, n.dtype, n.param("value_hash")) for n in g if n.op == "const"]
    assert len(consts) == len(set(consts)) == 3  # 0.5 and 1.0 in f32, 0.5 in bf16


# ------------------------------------------------------------- the rank
def test_rank_is_axis_index_and_fake_group_is_torn_down():
    import torch.distributed as dist

    for tp in (1, 2, 4):
        g, ins, _ = trace_sharded(
            lambda ctx, t, i: collectives.vp_embed(t, i, ctx), tp,
            (P("model", None), P()), ShapeDtype((32, 8), BF16), ShapeDtype((2, 5), I64))
        assert not dist.is_initialized()
        ax = [n for n in g if n.op == "axis_index"]
        assert len(ax) == 1 and ax[0].param("axes") == ("model",)
        assert ax[0].dtype == "int64" and ax[0].scope == "" and ax[0].src.startswith(
            "collectives.py:")
        off = g[g.consumers(ax[0].id)[0]]
        assert off.op == "mul" and g[off.inputs[1]].param("value") == 32 // tp
        assert [g[i].shape for i in ins] == [(32 // tp, 8), (2, 5)]
        ar = [n for n in g if n.op == "all_reduce"]
        assert len(ar) == 1 and ar[0].param("reduce_op") == "add"
        assert ar[0].param("groups") == "full"


def test_verify_sharded_function_pairs():
    def f(x, w):
        return torch.tanh(x @ w)

    x, w = ShapeDtype((4, 16), F32), ShapeDtype((16, 8), F32)
    column = verify_sharded(f, lambda ctx, x, w: f(x, w), x, w, size=4,
                            in_specs=(P(), P(None, "model")),
                            output_specs=[OutputSpec(kind="shard", dim=1)])
    assert column.verified
    row_specs = (P(None, "model"), P("model", None))
    row = verify_sharded(f, lambda ctx, x, w: torch.tanh(ctx.psum_tp(x @ w)), x, w,
                         size=4, in_specs=row_specs)
    assert row.verified
    no_psum = verify_sharded(f, lambda ctx, x, w: f(x, w), x, w, size=4,
                             in_specs=row_specs)
    assert not no_psum.verified
    assert no_psum.bug_sites[0].src.startswith("test_torch_trace.py:")


@pytest.mark.parametrize("pieces", [2, 8])
def test_gather_cut_into_other_than_its_ranks_stays_unfolded(pieces):
    """A dim-0 all_gather whose result is cut into as many pieces as the
    group has ranks and concatenated along a dim is one tiled all_gather
    along that dim; cut into any other count it is not, so the gather stays
    along dim 0 with the split and concat after it."""
    from repro_torch.parallel.ctx import _c10d

    def gather(ctx, x, n):
        y = _c10d().wait_tensor(_c10d().all_gather_into_tensor(x, 4, ctx._group()))
        return torch.cat(torch.chunk(y, n, dim=0), dim=1)

    x = ShapeDtype((8, 8, 3), F32)
    for n, dim in ((4, 1), (pieces, 0)):
        g, _, _ = trace_sharded(lambda ctx, x: gather(ctx, x, n), 4,
                                (P(None, "model"),), x)
        ag = [nd for nd in g if nd.op == "all_gather"]
        assert len(ag) == 1 and ag[0].param("all_gather_dimension") == dim
        assert ("concat" in _ops(g)) == (n != 4)

# ------------------------------------------------------------- model traces
@pytest.fixture(scope="module")
def llama_pair():
    cfg = dataclasses.replace(get_config("llama3_8b", smoke=True), n_layers=3)
    plan = Plan(tp=2, layers=3, seq=8, smoke=True)
    return build_pair("llama3_8b", plan, plan.scenarios()[0], stamp=False), cfg


def test_layer_tags_follow_scopes(llama_pair):
    pair, cfg = llama_pair
    for g in (pair.base, pair.dist):
        tagged = collections.Counter(n.layer for n in g if n.layer is not None)
        assert sorted(tagged) == [i * LAYER_TAG_STRIDE for i in range(cfg.n_layers)]
        for n in g:
            if n.layer is not None:
                assert n.scope.startswith(f"layer{n.layer // LAYER_TAG_STRIDE}")
    embed = [n for n in pair.dist if n.scope == "vp_embed"]
    assert embed and all(n.layer is None for n in embed)


def test_model_nodes_carry_src(llama_pair):
    pair, _ = llama_pair
    model_files = {"model.py", "attention.py", "mlp.py", "modules.py"}
    for g in (pair.base, pair.dist):
        body = [n for n in g if n.op not in ("input", "const")]
        assert all(n.src for n in body)
        files = collections.Counter(n.src.split(":")[0] for n in body)
        assert model_files <= set(files), files
        assert set(files) <= model_files | {"collectives.py", "ctx.py"}
        for n in body:
            if n.op == "dot" and n.src.startswith("modules.py"):
                line = int(n.src.split(":")[1])
                src = model_mod.__file__.replace("model.py", "modules.py")
                assert "@" in open(src).read().splitlines()[line - 1]


def test_stamped_trace_equals_full_trace():
    arch, tp, total = "llama3_8b", 2, TRACE_PERIODS + 3
    cfg = dataclasses.replace(get_config(arch, smoke=True), n_layers=total)
    pair_fn = lambda c: _tp_forward_parts(arch, c, tp, 1, 8, BuildCtx())  # noqa: E731
    parts, _ = stamped_parts(cfg, pair_fn, cfg.block_period)
    assert parts is not None, "periodic trace must stamp, not fall back"
    sb, b_in, sd, d_in, _ = parts
    fb, fb_in, fd, fd_in, _ = pair_fn(cfg)
    for stamped, full in ((sb, fb), (sd, fd)):
        assert stamped.stamp is not None
        assert len(stamped.nodes) == len(full.nodes)
        for a, b in zip(stamped.nodes, full.nodes):
            assert a == b, f"node {a.id}:\n  stamped: {a}\n  full:    {b}"
        assert stamped.outputs == full.outputs
    assert b_in == fb_in and d_in == fd_in


# ------------------------------------------------------------- the embedding
def _verify(pair):
    return verify_graphs(pair.base, pair.dist, size=pair.size,
                         input_facts=pair.input_facts, base_inputs=pair.base_inputs,
                         dist_inputs=pair.dist_inputs, output_specs=pair.output_specs)


def test_embedding_mask_off_by_one_stays_unverified(monkeypatch):
    """The single-device lookup's NaN fill (a select after the gather) is the
    embedding's output only with exactly ``0 <= id < V``."""
    plan = Plan(tp=2, layers=1, seq=8, smoke=True)
    scen = plan.scenarios()[0]
    assert _verify(build_pair("llama3_8b", plan, scen, stamp=False)).verified

    real = Model._embed_tokens

    def off_by_one(self, params, ids, allow_sp=True):
        if self.ctx.tp_axis:
            return real(self, params, ids, allow_sp)
        table = params["embed"]["w"]
        V = table.shape[0]
        ids = torch.where(ids < 0, ids + V, ids)
        valid = (ids >= 0) & (ids < V - 1)
        x = table[ids.clamp(0, V - 1)]
        return torch.where(valid[..., None], x, torch.full((), float("nan"),
                                                           dtype=x.dtype))

    monkeypatch.setattr(Model, "_embed_tokens", off_by_one)
    rep = _verify(build_pair("llama3_8b", plan, scen, stamp=False))
    assert not rep.verified


def test_faulty_template_generator_is_caught(monkeypatch):
    """The trusted vp_embed template is checked on a small table before it
    is trusted: an offset of (rank + 1) * V_loc leaves the pair unverified,
    with a bug site in the lookup."""
    plan = Plan(tp=2, layers=1, seq=8, smoke=True)
    scen = plan.scenarios()[0]

    def shifted(table, ids, rank):
        V_loc = table.shape[0]
        off = (rank + 1) * V_loc
        local = (ids - off).clamp(0, V_loc - 1)
        x = table[local]
        mask = ((ids >= off) & (ids < off + V_loc))[..., None]
        return x * mask.to(x.dtype)

    monkeypatch.setattr(collectives, "vp_embed_partial", shifted)
    monkeypatch.setattr(meta, "_generator_checked", {})
    monkeypatch.setattr(meta, "_vp_embed_templates", {})
    rep = _verify(build_pair("llama3_8b", plan, scen, stamp=False))
    assert not rep.verified
    assert any(b.src.startswith("test_torch_trace.py") for b in rep.bug_sites[:3])


def test_sp_embedding_is_covered_and_a_shifted_offset_is_not(monkeypatch):
    """Under sequence parallelism the meta rule covers the ``vp_embed_sp``
    region (the partial lookup; the sequence reduce_scatter after it is
    discharged by the collective rule), and a shifted offset in the partial
    leaves the pair unverified, as without SP."""
    plan = Plan(tp=2, layers=1, seq=8, smoke=True, sp=True)
    scen = plan.scenarios()[0]
    pair = build_pair("llama3_8b", plan, scen, stamp=False)
    region = [n for n in pair.dist if n.scope == "vp_embed_sp"]
    assert region and not any(n.op in ("all_reduce", "reduce_scatter") for n in region)
    rs = [n for n in pair.dist if n.op == "reduce_scatter"]
    assert rs and all(n.param("scatter_dimension") == 1 for n in rs)
    assert _verify(pair).verified

    def shifted(table, ids, rank):
        V_loc = table.shape[0]
        off = (rank + 1) * V_loc
        local = (ids - off).clamp(0, V_loc - 1)
        x = table[local]
        mask = ((ids >= off) & (ids < off + V_loc))[..., None]
        return x * mask.to(x.dtype)

    monkeypatch.setattr(collectives, "vp_embed_partial", shifted)
    monkeypatch.setattr(meta, "_generator_checked", {})
    monkeypatch.setattr(meta, "_vp_embed_templates", {})
    rep = _verify(build_pair("llama3_8b", plan, scen, stamp=False))
    assert not rep.verified
    assert any(b.src.startswith("test_torch_trace.py") for b in rep.bug_sites[:3])


@pytest.mark.parametrize("reduce", ["pmax_tp", "psum_twice"])
def test_faulty_template_reduction_is_caught(monkeypatch, reduce):
    """The trusted template's reduction is checked too: a ``vp_embed`` that
    reduces with a max, or adds the sum to itself, in both the model and
    the template leaves the pair unverified."""
    plan = Plan(tp=2, layers=1, seq=8, smoke=True)
    scen = plan.scenarios()[0]

    def wrong(table, ids, ctx):
        x = collectives.vp_embed_partial(table, ids, ctx.tp_index())
        if reduce == "pmax_tp":
            return ctx.pmax_tp(x)
        y = ctx.psum_tp(x)
        return y + y

    monkeypatch.setattr(collectives, "vp_embed", wrong)
    monkeypatch.setattr(model_mod, "vp_embed", wrong)
    monkeypatch.setattr(meta, "_generator_checked", {})
    monkeypatch.setattr(meta, "_vp_embed_templates", {})
    rep = _verify(build_pair("llama3_8b", plan, scen, stamp=False))
    assert not rep.verified
