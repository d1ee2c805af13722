"""The same IR through both verifiers: the JAX package's ``verify_graphs`` and
the port's give byte-identical ``Report.canonical()`` and equal canonical
fact sets, on both engines with fusion on and off.

Inputs: ``synth.fuzz_tp_mlp`` seeds (built directly in IR), the JAX-traced
llama3_8b and qwen3_4b tp-forward pairs at tp 4 with 2 layers (full width),
and every registered injector's mutation of the llama3_8b pair, each graph
rebuilt node for node in the port's ``Graph``.  The vp_embed meta rule is
the one tracer-dependent rule (its template is traced by each package's own
tracer, and a JAX fingerprint cannot match a torch trace); the port's rule
here asks the JAX template, so both verifiers see the same template
decision."""
import json

import pytest

pytest.importorskip("torch")

from repro.core import ir as jir  # noqa: E402
from repro.core import synth as jsynth  # noqa: E402
from repro.core import verifier as jverifier  # noqa: E402
from repro.core.inject import DEFAULT_INJECTORS  # noqa: E402
from repro.core.rules import meta as jmeta  # noqa: E402
from repro.verify.plan import Plan  # noqa: E402
from repro.verify.scenarios import build_pair  # noqa: E402

from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core import verifier as tverifier  # noqa: E402
from repro_torch.core.rules import meta as tmeta  # noqa: E402
from repro_torch.core.verifier import InputFact  # noqa: E402

FUZZ_SEEDS = list(range(6))
# tp-forward without sequence parallelism has no all_gather or reduce_scatter
NO_SITE = ("wrong_all_gather_dim", "wrong_scatter_dim")
OPTIONS = [("worklist", True), ("worklist", False), ("passes", True),
           ("passes", False)]


def to_port(g):
    """A JAX-package Graph rebuilt node for node in the port's Graph."""
    out = tir.Graph(g.name)
    for n in g.nodes:
        out.add(n.op, n.inputs, n.shape, n.dtype, dict(n.params), src=n.src,
                layer=n.layer, scope=n.scope)
    out.mark_output(*g.outputs)
    out.input_alias = dict(getattr(g, "input_alias", None) or {})
    # repr: each package canonicalizes NaN params to its own NaN object
    assert [repr(a) for a in out.nodes] == [repr(b) for b in g.nodes]
    return out


def _canonical_fact(f) -> tuple:
    lay = f.layout
    return (f.kind, f.base, f.dist, f.size,
            (lay.atoms, lay.src_groups, lay.perm, lay.dst_groups),
            f.reduce_op, f.dim, f.nchunk, f.index, tuple(sorted(f.idxset)))


def _run(vmod, monkeypatch, base, dist, kw, engine, fusion):
    """verify_graphs of one package, with its Propagator captured for the
    fact set."""
    made = []
    cls = vmod.Propagator

    class Recording(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(vmod, "Propagator", Recording)
    opts = vmod.VerifyOptions(engine=engine, fusion=fusion, axis=kw.pop("axis", "model"))
    rep = vmod.verify_graphs(base, dist, options=opts, **kw)
    monkeypatch.setattr(vmod, "Propagator", cls)
    assert len(made) == 1
    facts = {_canonical_fact(f) for fs in made[0].store.by_dist.values() for f in fs}
    return json.dumps(rep.canonical(), sort_keys=True), facts, rep.verified


def _cases():
    """(name, thunk) -> (base, dist, size, input facts, base/dist inputs,
    output specs) of JAX-package graphs."""
    cases = []
    for seed in FUZZ_SEEDS:
        def fuzz(seed=seed):
            pair, spec = jsynth.fuzz_tp_mlp(seed)
            facts = [(f.kind, f.base_index, f.dist_index, f.dim)
                     for f in jsynth.input_facts_of(pair)]
            return pair.base, pair.dist, spec.size, facts, pair.base_inputs, \
                pair.dist_inputs, None
        cases.append((f"fuzz{seed}", fuzz))
    for arch in ("llama3_8b", "qwen3_4b"):
        cases.append((f"{arch}-tp4", lambda arch=arch: _model_case(arch)))
    for spec in DEFAULT_INJECTORS.specs():
        if spec.name not in NO_SITE:
            cases.append((f"llama3_8b-{spec.name}",
                          lambda spec=spec: _injected_case(spec)))
    return cases


_PAIRS: dict = {}


def _jax_pair(arch):
    if arch not in _PAIRS:
        plan = Plan(tp=4, layers=2, seq=32, batch=2)  # the campaign's plan
        _PAIRS[arch] = build_pair(arch, plan, plan.scenarios()[0], stamp=False)
    return _PAIRS[arch]


def _model_case(arch, dist=None):
    p = _jax_pair(arch)
    facts = [(f.kind, f.base_index, f.dist_index, f.dim) for f in p.input_facts]
    specs = [(s.kind, s.dim, s.reduce_op) for s in p.output_specs]
    return p.base, dist if dist is not None else p.dist, p.size, facts, \
        p.base_inputs, p.dist_inputs, specs


def _injected_case(spec):
    p = _jax_pair("llama3_8b")
    inj = spec(p.dist, index=1) or spec(p.dist)
    assert inj is not None, f"{spec.name}: no site in the tp-forward graph"
    return _model_case("llama3_8b", inj.graph)


@pytest.mark.parametrize("name", NO_SITE)
def test_injectors_without_a_site(name):
    spec = DEFAULT_INJECTORS.get(name)
    assert spec(_jax_pair("llama3_8b").dist) is None


@pytest.mark.parametrize("engine,fusion", OPTIONS, ids=[f"{e}-fusion{int(f)}"
                                                          for e, f in OPTIONS])
@pytest.mark.parametrize("name,case", _cases(), ids=[n for n, _ in _cases()])
def test_same_ir_same_report(name, case, engine, fusion, monkeypatch):
    base, dist, size, facts, b_in, d_in, specs = case()
    # the port's vp_embed meta rule asks the JAX template about JAX regions,
    # and both packages share one NaN object (structural hashes of params
    # with a NaN fill value compare the NaN by identity)
    monkeypatch.setattr(tmeta, "_vp_embed_template_ok", jmeta._vp_embed_template_ok)
    monkeypatch.setattr(tir, "_CANON_NAN", jir._CANON_NAN)
    results = []
    for vmod, g_b, g_d in ((jverifier, base, dist),
                           (tverifier, to_port(base), to_port(dist))):
        kw = dict(size=size, base_inputs=b_in, dist_inputs=d_in,
                  input_facts=[(jverifier.InputFact if vmod is jverifier
                                else InputFact)(*f) for f in facts],
                  output_specs=None if specs is None else
                  [vmod.OutputSpec(*s) for s in specs])
        results.append(_run(vmod, monkeypatch, g_b, g_d, kw, engine, fusion))
    (j_canon, j_facts, j_ok), (t_canon, t_facts, t_ok) = results
    assert j_ok == t_ok
    if name.endswith("-tp4") or name.startswith("fuzz"):
        assert j_ok, f"{name}: the clean pair must verify"
    assert t_canon == j_canon
    assert t_facts == j_facts
