"""The program's run-time spans (``scope.span``, ``scope.spans``) and the
reduction of a trace of them (``scripts/layer_spans.py``).

Off (the default) a forward enters no ``record_function`` and its logits
equal those with the spans on, bit for bit.  On, a kineto trace cut to
user-scope ranges records exactly ``scope.SPANS``' names for a dense, a
MoE and a hybrid model at SMOKE size: each ``model.*`` span once a forward
and each layer's span once a layer of its kind (the ``ssm.*`` spans once a
Mamba-2 layer, the ``attn.*`` spans once an attention layer), all nested
inside ``model.forward``.  A verifier
trace of a forward with the spans on has no profiler nodes and equals the
trace with them off.  On hand-made events, a kernel's device time goes to
the innermost program span its launch call lies in, an idle gap to the
innermost span the host was in, and a trace without program spans reads
null for the three readings."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import scope  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.trace import ShapeDtype, fx_program, trace  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATTN = ("attn.qkv", "attn.rope", "attn.core", "attn.out")
SSM = ("ssm.proj", "ssm.conv", "ssm.scan", "ssm.norm", "ssm.out")
MOE = ("moe.router", "moe.positions", "moe.gather", "moe.experts", "moe.combine")
LAYER = {"dense": ATTN + ("mlp",), "moe": ATTN + MOE, "hybrid": ATTN + SSM + MOE}
ARCH = {"dense": "chatglm3_6b", "moe": "granite_moe_3b", "hybrid": "granite_4_0_h_small"}


def layer_spans(cfg, i: int) -> tuple:
    """The spans layer ``i`` of ``cfg`` opens, once each."""
    mixer = ATTN if cfg.is_attn_layer(i) else SSM
    return mixer + (MOE if cfg.is_moe_layer(i) else ("mlp",))


def _layer_spans():
    spec = importlib.util.spec_from_file_location("layer_spans",
                                                  ROOT / "scripts" / "layer_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model(kind: str, impl: str = "kernel"):
    cfg = dataclasses.replace(get_config(ARCH[kind], smoke=True), dtype=torch.float32)
    model = Model(cfg, impl=impl, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    return model, params, {"tokens": tokens}


@pytest.mark.parametrize("kind", ["dense", "moe", "hybrid"])
def test_spans_off_enter_no_record_function_and_change_no_logit(kind, monkeypatch):
    from torch.autograd import profiler

    entered = []
    real = profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(profiler, "record_function", counting)
    model, params, batch = _model(kind)
    with torch.inference_mode():
        off = model.forward(params, batch)
        assert entered == []
        with scope.spans():
            on = model.forward(params, batch)
        assert not scope._spans_on
        again = model.forward(params, batch)
    cfg = model.cfg
    per_layer = [n for i in range(cfg.n_layers) for n in layer_spans(cfg, i)]
    assert len(entered) == 3 + len(per_layer)  # and none after the block
    assert sorted(entered) == sorted(per_layer + ["model.forward", "model.embed", "model.head"])
    assert torch.equal(off, on) and torch.equal(off, again)


def test_span_off_is_one_shared_null_context():
    assert scope.span("model.forward") is scope.span("attn.core")
    with scope.spans():
        with scope.spans():
            pass
        assert scope._spans_on
        assert scope.span("attn.core") is not scope.span("attn.core")
    assert not scope._spans_on


@pytest.mark.parametrize("kind", ["dense", "moe", "hybrid"])
def test_spans_recorded_under_a_user_scope_trace(kind):
    ls = _layer_spans()
    model, params, batch = _model(kind)
    forwards = 2
    with torch.inference_mode(), scope.spans(), ls.user_scope_profiler(cuda=False) as got:
        for _ in range(forwards):
            model.forward(params, batch)
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in got["events"]]
    # the trace holds the spans and no op of the host
    names = [n for n, _, _ in ranges]
    assert set(names) == {"model.forward", "model.embed", "model.head"} | set(LAYER[kind])
    assert set(names) <= set(scope.SPANS)
    cfg = model.cfg
    per_layer = [n for i in range(cfg.n_layers) for n in layer_spans(cfg, i)]
    for name in set(names):
        want = 1 if name.startswith("model.") else per_layer.count(name)
        assert names.count(name) == forwards * want, name
    outer = [(s, e) for n, s, e in ranges if n == "model.forward"]
    for n, s, e in ranges:
        assert any(s0 <= s and e <= e0 for s0, e0 in outer), n


@pytest.mark.parametrize("kind", ["dense", "moe", "hybrid"])
def test_verifier_trace_has_no_profiler_nodes_with_spans_on(kind):
    model, params, batch = _model(kind, impl="reference")
    shapes = (tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), params),
              {"tokens": ShapeDtype(tuple(batch["tokens"].shape), batch["tokens"].dtype)})
    fn = model.forward
    off = fx_program(fn, *shapes)
    g_off, _, _ = trace(fn, *shapes)
    with scope.spans():
        on = fx_program(fn, *shapes)
        g_on, _, _ = trace(fn, *shapes)
    assert not [n for n in on.graph.nodes if "profiler" in str(n.target)]
    assert on.code == off.code
    assert [vars(n) for n in g_on] == [vars(n) for n in g_off]


# ------------------------------------------------------------ the reduction
def _ev(kind, name, s, e, c=0):
    return (kind, name, s, e, c)


# one request around one forward; inside it the embedding (one kernel), a
# layer whose moe.gather launches a kernel from inside a child of no name the
# program knows, and a launch directly under model.forward; times in ns
EVENTS = [
    _ev("span", "request", 0, 1000),
    _ev("span", "model.forward", 10, 900),
    _ev("span", "model.embed", 20, 100),
    _ev("launch", "cudaLaunchKernel", 30, 35, 1),
    _ev("device", "embed_kernel", 40, 140, 1),
    _ev("span", "moe.gather", 300, 400),
    _ev("span", "index_helper", 310, 330),            # the caller's own span
    _ev("launch", "cudaLaunchKernel", 320, 325, 2),
    _ev("device", "index_copy", 340, 540, 2),
    _ev("launch", "cudaLaunchKernel", 500, 505, 3),   # model.forward's own
    _ev("device", "norm", 600, 700, 3),
    _ev("launch", "cudaMemcpyAsync", 950, 960, 4),    # outside any program span
    _ev("device", "memcpy", 960, 990, 4),
    _ev("device", "stray", 995, 1000, 99),            # no launch call in the trace
]


def test_self_device_time_goes_to_the_innermost_program_span():
    red = _layer_spans().reduce_spans(EVENTS, "request", scope.SPANS)
    t = red["program_spans"]
    assert t["model.embed"]["self_device_s"] == pytest.approx(100e-9)
    assert t["moe.gather"]["self_device_s"] == pytest.approx(200e-9)
    assert t["model.forward"]["self_device_s"] == pytest.approx(100e-9)
    assert red["outside_device_s"] == pytest.approx(30e-9)
    assert red["unmatched_device_s"] == pytest.approx(5e-9)
    assert red["device_s"] == pytest.approx(435e-9)
    assert t["model.forward"]["calls"] == 1
    assert t["model.forward"]["host_s"] == pytest.approx(890e-9)
    assert t["model.embed"]["top_ops"] == [["embed_kernel", pytest.approx(100e-9)]]
    assert "index_helper" not in t and "request" not in t
    assert [t[n]["launches"] for n in ("model.forward", "model.embed", "moe.gather")] == [1, 1, 1]
    r = red["readings"]
    assert r["launches_per_forward"] == 3  # launches 1, 2 and 3; 4 lies outside
    assert r["moe_dispatch_ms"] == pytest.approx(200e-9 * 1e3)


def test_idle_gaps_are_labelled_by_the_innermost_span():
    red = _layer_spans().reduce_spans(EVENTS, "request", scope.SPANS)
    # busy: [40, 140], [340, 540], [600, 700], [960, 990], [995, 1000]; the
    # gaps [0, 40) in request, [140, 340) in model.forward (embed ended at
    # 100), [540, 600) and [700, 960) in model.forward, [990, 995) in request
    gaps = dict(red["idle_gaps"])
    assert gaps["request (2 gaps)"] == pytest.approx(45e-9)
    assert gaps["model.forward (3 gaps)"] == pytest.approx(520e-9)
    assert red["program_spans"]["model.forward"]["idle_s"] == pytest.approx(520e-9)
    assert red["program_spans"]["moe.gather"]["idle_s"] == 0.0
    assert red["readings"]["forward_idle_pct"] == pytest.approx(100 * 520 / 1000)
    assert red["busy_s"] == pytest.approx(435e-9)


def test_a_trace_without_program_spans_reads_null():
    ls = _layer_spans()
    bare = [e for e in EVENTS if e[0] != "span" or e[1] == "request"]
    red = ls.reduce_spans(bare, "request", ())
    assert red["program_spans"] == {}
    assert red["readings"] == {"moe_dispatch_ms": None, "ssm_mixer_ms": None,
                               "forward_idle_pct": None, "launches_per_forward": None}
    assert red["outside_device_s"] == pytest.approx(430e-9)
    # a dense forward has no dispatch to read
    dense = [e for e in EVENTS if e[1] != "moe.gather"]
    r = ls.reduce_spans(dense, "request", scope.SPANS)["readings"]
    assert r["moe_dispatch_ms"] is None and r["launches_per_forward"] == 3
    assert r["ssm_mixer_ms"] is None


def test_ssm_mixer_ms_sums_the_ssm_spans_self_device_time():
    # the layer's span as a Mamba-2 mixer's scan, and a second kernel in its norm
    events = [e if e[1] != "moe.gather" else _ev("span", "ssm.scan", 300, 400)
              for e in EVENTS]
    events += [_ev("span", "ssm.norm", 700, 800), _ev("launch", "cudaLaunchKernel", 710, 715, 5),
               _ev("device", "gated_norm", 720, 770, 5)]
    r = _layer_spans().reduce_spans(events, "request", scope.SPANS)["readings"]
    assert r["ssm_mixer_ms"] == pytest.approx((200e-9 + 50e-9) * 1e3)
    assert r["moe_dispatch_ms"] is None
