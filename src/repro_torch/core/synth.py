"""Synthetic TensorIR graph pairs for benchmarks and engine-parity tests.

``deep_tp_mlp`` builds the canonical tensor-parallel residual-MLP stack
directly in TensorIR (no jax tracing): per layer, a column-parallel matmul,
a tanh, a row-parallel matmul producing an add-partial, an all_reduce, and
a residual add.  Layer tags make the pair partitionable/memoizable; every
layer is structurally identical, so layer memoization hits on all but the
first.

``fuzz_tp_mlp`` is the seeded metamorphic fuzzer behind the
detection-benchmark campaign (:mod:`repro.verify.campaign`): it randomizes
the ``deep_tp_mlp`` skeleton — layer count, widths, device count,
activation choice, collective placement (psum vs reduce_scatter/all_gather
round trip), and reshape/transpose layout chains — while keeping the pair
semantically equivalent *by construction*, so a clean fuzz pair must verify
(any failure is a false positive) and a pair mutated through the injector
registry must not (any pass is a missed detection).  All randomness flows
from one ``random.Random(seed)``: the same seed rebuilds the same graphs.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

from .ir import Graph

DN = ((((1,), (0,)), ((), ())),)  # dot dimension_numbers: plain matmul


@dataclass
class SynthPair:
    base: Graph
    dist: Graph
    base_inputs: list[int] = field(default_factory=list)
    dist_inputs: list[int] = field(default_factory=list)
    # (kind, base_input_index, dist_input_index, shard_dim)
    input_relations: list[tuple] = field(default_factory=list)


def deep_tp_mlp(
    n_layers: int = 32,
    batch: int = 4,
    width: int = 32,
    hidden: int = 64,
    size: int = 8,
    tag_layers: bool = True,
) -> SynthPair:
    """Baseline vs TP-sharded residual MLP stack over ``size`` devices."""
    B, H, F, c = batch, width, hidden, size
    assert F % c == 0, "hidden width must divide the device count"
    dn = {"dimension_numbers": DN[0]}

    gb = Graph("base")
    x = gb.add("input", (), (B, H), "float32")
    pair = SynthPair(gb, Graph("dist"))
    pair.base_inputs.append(x)
    for li in range(n_layers):
        tag = li if tag_layers else None
        w1 = gb.add("param", (), (H, F), "float32", layer=tag)
        w2 = gb.add("param", (), (F, H), "float32", layer=tag)
        pair.base_inputs += [w1, w2]
        h = gb.add("dot", [x, w1], (B, F), "float32", dn, layer=tag,
                   src=f"mlp.py:{10 + li}")
        t = gb.add("tanh", [h], (B, F), "float32", layer=tag)
        y = gb.add("dot", [t, w2], (B, H), "float32", dn, layer=tag)
        x = gb.add("add", [x, y], (B, H), "float32", layer=tag)
    gb.mark_output(x)

    gd = pair.dist
    xd = gd.add("input", (), (B, H), "float32")
    pair.dist_inputs.append(xd)
    pair.input_relations.append(("dup", 0, 0, -1))
    for li in range(n_layers):
        tag = li if tag_layers else None
        w1d = gd.add("param", (), (H, F // c), "float32", layer=tag)
        w2d = gd.add("param", (), (F // c, H), "float32", layer=tag)
        i1 = len(pair.dist_inputs)
        pair.dist_inputs += [w1d, w2d]
        pair.input_relations += [("shard", i1, i1, 1), ("shard", i1 + 1, i1 + 1, 0)]
        hd = gd.add("dot", [xd, w1d], (B, F // c), "float32", dn, layer=tag,
                    src=f"mlp.py:{10 + li}")
        td = gd.add("tanh", [hd], (B, F // c), "float32", layer=tag)
        yd = gd.add("dot", [td, w2d], (B, H), "float32", dn, layer=tag)
        ar = gd.add("all_reduce", [yd], (B, H), "float32",
                    {"reduce_op": "add", "axes": ("model",)}, layer=tag,
                    src=f"mlp.py:{100 + li}")
        xd = gd.add("add", [xd, ar], (B, H), "float32", layer=tag)
    gd.mark_output(xd)
    return pair


# --------------------------------------------------------------- fuzzer

# unary elementwise activations every rule engine treats uniformly
_FUZZ_ACTS = ("tanh", "logistic", "exp", "abs")


@dataclass
class FuzzSpec:
    """The decisions one seed expanded to (recorded in campaign reports)."""

    seed: int
    n_layers: int
    size: int
    batch: int
    width: int
    hidden: int
    acts: tuple = ()
    collectives: tuple = ()  # per layer: "all_reduce" | "scatter_gather"
    chains: tuple = ()  # per layer: "" | "shared" | "dist_identity"

    def to_dict(self) -> dict:
        return {
            "seed": self.seed, "n_layers": self.n_layers, "size": self.size,
            "batch": self.batch, "width": self.width, "hidden": self.hidden,
            "acts": list(self.acts), "collectives": list(self.collectives),
            "chains": list(self.chains),
        }


def _chain_factors(h: int) -> tuple[int, int]:
    """Split ``h`` into two non-unit factors (h is a power of two >= 4)."""
    f = 2
    while h % f or (h // f) < 2:
        f += 1
    return f, h // f


def _identity_chain(g: Graph, x: int, batch: int, width: int, tag,
                    src: str) -> int:
    """reshape/transpose round trip that is the identity on data: the layout
    rules must compose it away (a mutation inside it must be caught)."""
    h1, h2 = _chain_factors(width)
    r = g.add("reshape", [x], (batch, h1, h2), "float32",
              {"new_sizes": (batch, h1, h2)}, layer=tag, src=src)
    t = g.add("transpose", [r], (batch, h2, h1), "float32",
              {"permutation": (0, 2, 1)}, layer=tag, src=src)
    t2 = g.add("transpose", [t], (batch, h1, h2), "float32",
               {"permutation": (0, 2, 1)}, layer=tag, src=src)
    return g.add("reshape", [t2], (batch, width), "float32",
                 {"new_sizes": (batch, width)}, layer=tag, src=src)


def _shared_chain(g: Graph, x: int, batch: int, width: int, tag,
                  src: str) -> int:
    """reshape -> transpose -> reshape permuting the feature dim, applied
    identically to BOTH graphs (congruence must relate the twin chains)."""
    h1, h2 = _chain_factors(width)
    r = g.add("reshape", [x], (batch, h1, h2), "float32",
              {"new_sizes": (batch, h1, h2)}, layer=tag, src=src)
    t = g.add("transpose", [r], (batch, h2, h1), "float32",
              {"permutation": (0, 2, 1)}, layer=tag, src=src)
    return g.add("reshape", [t], (batch, width), "float32",
                 {"new_sizes": (batch, width)}, layer=tag, src=src)


def fuzz_tp_mlp(seed: int, tag_layers: bool = True
                ) -> tuple[SynthPair, FuzzSpec]:
    """Seeded random TP residual-MLP pair (clean by construction).

    Per layer the seed picks the activation, the partial-sum discharge
    (``all_reduce`` vs an SP-style ``reduce_scatter``/``all_gather`` round
    trip), and an optional layout chain (identical in both graphs, or a
    net-identity chain in the distributed graph only).  Shapes are chosen so
    every collective divides evenly; sources are tagged ``fuzz{seed}.py:L``
    for localization checks.
    """
    rng = random.Random(seed)
    size = rng.choice([2, 4, 8])
    n_layers = rng.randint(1, 4)
    batch = rng.choice([2, 4])
    width = rng.choice([8, 16, 32])
    hidden = size * rng.choice([2, 4, 8])
    acts = tuple(rng.choice(_FUZZ_ACTS) for _ in range(n_layers))
    collectives = tuple(
        rng.choice(("all_reduce", "scatter_gather")) for _ in range(n_layers))
    chains = tuple(
        rng.choice(("", "shared", "dist_identity")) for _ in range(n_layers))
    spec = FuzzSpec(seed, n_layers, size, batch, width, hidden,
                    acts, collectives, chains)

    B, H, F, c = batch, width, hidden, size
    dn = {"dimension_numbers": DN[0]}

    gb = Graph(f"fuzz{seed}-base")
    x = gb.add("input", (), (B, H), "float32")
    pair = SynthPair(gb, Graph(f"fuzz{seed}-dist"))
    pair.base_inputs.append(x)
    for li in range(n_layers):
        tag = li if tag_layers else None
        w1 = gb.add("param", (), (H, F), "float32", layer=tag)
        w2 = gb.add("param", (), (F, H), "float32", layer=tag)
        pair.base_inputs += [w1, w2]
        if chains[li] == "shared":
            x = _shared_chain(gb, x, B, H, tag, f"fuzz{seed}.py:{40 + li}")
        h = gb.add("dot", [x, w1], (B, F), "float32", dn, layer=tag,
                   src=f"fuzz{seed}.py:{10 + li}")
        t = gb.add(acts[li], [h], (B, F), "float32", layer=tag)
        y = gb.add("dot", [t, w2], (B, H), "float32", dn, layer=tag,
                   src=f"fuzz{seed}.py:{20 + li}")
        x = gb.add("add", [x, y], (B, H), "float32", layer=tag)
    gb.mark_output(x)

    gd = pair.dist
    xd = gd.add("input", (), (B, H), "float32")
    pair.dist_inputs.append(xd)
    pair.input_relations.append(("dup", 0, 0, -1))
    for li in range(n_layers):
        tag = li if tag_layers else None
        w1d = gd.add("param", (), (H, F // c), "float32", layer=tag)
        w2d = gd.add("param", (), (F // c, H), "float32", layer=tag)
        i1 = len(pair.dist_inputs)
        pair.dist_inputs += [w1d, w2d]
        pair.input_relations += [("shard", i1, i1, 1),
                                 ("shard", i1 + 1, i1 + 1, 0)]
        if chains[li] == "shared":
            xd = _shared_chain(gd, xd, B, H, tag, f"fuzz{seed}.py:{40 + li}")
        elif chains[li] == "dist_identity":
            xd = _identity_chain(gd, xd, B, H, tag, f"fuzz{seed}.py:{50 + li}")
        hd = gd.add("dot", [xd, w1d], (B, F // c), "float32", dn, layer=tag,
                    src=f"fuzz{seed}.py:{10 + li}")
        td = gd.add(acts[li], [hd], (B, F // c), "float32", layer=tag)
        yd = gd.add("dot", [td, w2d], (B, H), "float32", dn, layer=tag,
                    src=f"fuzz{seed}.py:{20 + li}")
        if collectives[li] == "all_reduce":
            red = gd.add("all_reduce", [yd], (B, H), "float32",
                         {"reduce_op": "add", "axes": ("model",)}, layer=tag,
                         src=f"fuzz{seed}.py:{100 + li}")
        else:
            # SP-style discharge: scatter the partial over the feature dim
            # (always divisible: width and hidden are multiples of size),
            # then gather it back — exercises reduce_scatter + all_gather
            rs = gd.add("reduce_scatter", [yd], (B, H // c), "float32",
                        {"reduce_op": "add", "scatter_dimension": 1,
                         "axes": ("model",)}, layer=tag,
                        src=f"fuzz{seed}.py:{100 + li}")
            red = gd.add("all_gather", [rs], (B, H), "float32",
                         {"all_gather_dimension": 1, "tiled": True,
                          "axes": ("model",)}, layer=tag,
                         src=f"fuzz{seed}.py:{110 + li}")
        xd = gd.add("add", [xd, red], (B, H), "float32", layer=tag)
    gd.mark_output(xd)
    return pair, spec


def fuzz_inject(pair: SynthPair, seed: int, names=None):
    """Apply one seeded registry injection to the pair's distributed graph.

    Returns the :class:`~repro.core.inject.Injection` (a mutated *copy* —
    ``pair`` itself is untouched), or ``None`` when no registered injector
    applies to this pair (tiny graphs may reject every site predicate).
    ``names`` restricts the draw to an injector subset (the campaign's
    ``--injectors`` selection applies to fuzz cells too)."""
    from .inject import DEFAULT_INJECTORS

    rng = random.Random(seed ^ 0x5EED)
    specs = DEFAULT_INJECTORS.applicable_to(pair.dist)
    if names is not None:
        specs = [s for s in specs if s.name in names]
    rng.shuffle(specs)
    for spec in specs:
        index = rng.randrange(4)
        inj = spec(pair.dist, index=index) or spec(pair.dist)
        if inj is not None:
            return inj
    return None


def input_facts_of(pair: SynthPair):
    """The pair's input relations as verifier ``InputFact`` records."""
    from .relations import DUP, SHARD
    from .verifier import InputFact

    out = []
    for kind, bi, di, dim in pair.input_relations:
        out.append(InputFact(DUP if kind == "dup" else SHARD, bi, di, dim))
    return out


def register_inputs(pair: SynthPair, prop) -> None:
    """Register the pair's input relations directly on a Propagator."""
    for kind, bi, di, dim in pair.input_relations:
        b, d = pair.base_inputs[bi], pair.dist_inputs[di]
        if kind == "dup":
            prop.register_dup(b, d)
        else:
            prop.register_shard(b, d, dim)
