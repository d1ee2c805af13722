"""The capacity dispatch's gather and combine kernels (``kernels/
moe_dispatch.py``, ``csrc/moe_dispatch.cu``) and ``moe_fwd(impl="kernel")``,
which moves its rows with them.

On the CPU the wrappers take the plain versions: ``moe_fwd(impl="kernel")``
equals ``impl="reference"`` bit for bit (capacity that drops pairs, an
expert-parallel rank whose remote pairs go to the overflow slot, f32 and
bf16), the plain gather and combine equal the reference's expressions, and
the wrappers refuse autograd-tracked inputs.  The tests marked ``card`` run
the kernels on a capability-(9, 0) device against the plain versions, bit
for bit, at granite_moe_3b's prefill layer (32,768 x 1536, 40 experts, C =
8,192), a D = 4096 mixtral_8x7b layer, a ragged token count and an EP rank,
then a whole granite_moe_3b forward against the same model with the
reference's dispatch; elsewhere they skip."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import moe_dispatch, ops  # noqa: E402
from repro_torch.models import Model, mlp  # noqa: E402
from repro_torch.models import model as model_module  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (arch, capacity factor, expert-parallel (rank, size) or None)
CASES = [("granite_moe_3b", 1.25, None), ("granite_moe_3b", 0.3, None),
         ("granite_moe_3b", 0.3, (1, 4)), ("mixtral_8x7b", 1.25, None),
         ("moonshot_v1_16b", 0.3, None)]


def _ep_rank(monkeypatch, p, ep, device="cpu"):
    """(context, parameters) of one expert-parallel rank, alone: its slice
    of the expert stacks, and its combine's partial sum left unreduced
    (``psum_ep`` the identity), as a rank's is before the all_reduce."""
    if ep is None:
        return ParallelCtx.single(), p
    rank, size = ep
    monkeypatch.setattr(ParallelCtx, "psum_ep", lambda self, x: x)
    n = p["wg"].shape[0] // size
    mine = {k: v[rank * n:(rank + 1) * n] for k, v in p.items() if k in ("wg", "wu", "wo")}
    return (ParallelCtx(ep_axis="model", ep_size=size,
                        rank=torch.tensor(rank, dtype=torch.int64, device=device)),
            {**p, **mine})


def _layer(arch, dtype, cf, *, device="cpu", tokens=(2, 16), seed=0, smoke=True,
           padded=True, skew=0.0):
    """One MoE layer's config, parameters and input; ``padded=False`` sets
    the zoo's padded experts back to the published count (granite: 40).
    ``skew`` adds one N(0, skew^2) vector to every token: the router then
    favours some experts over all tokens, so capacity drops pairs, as in a
    model whose tokens route alike (independent N(0, 1) tokens load 40
    experts so evenly that capacity 1.25 drops none at 32,768 tokens)."""
    cfg = dataclasses.replace(get_config(arch, smoke=smoke), capacity_factor=cf)
    if not padded:
        cfg = dataclasses.replace(cfg, n_experts_padded=0)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = mlp.moe_init(gen, cfg, dtype=dtype)
    x = torch.randn((*tokens, cfg.d_model), generator=gen, device=device)
    x = x + skew * torch.randn((cfg.d_model,), generator=gen, device=device)
    return cfg, p, x.to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch,cf,ep", CASES, ids=lambda c: str(c))
def test_kernel_dispatch_equals_reference(arch, cf, ep, dtype, monkeypatch):
    cfg, p, x = _layer(arch, DTYPES[dtype], cf)
    ctx, p = _ep_rank(monkeypatch, p, ep)
    with mlp.record_routing() as routing:
        want = mlp.moe_fwd(cfg, ctx, p, x)
    got = mlp.moe_fwd(cfg, ctx, p, x, impl="kernel")
    assert got.dtype == want.dtype and torch.equal(got, want)
    if cf < 1:
        assert int(routing[0]["dropped"]) > 0


def _pairs(T, E, K, C, first=0, E_loc=None, seed=0):
    """A routing as ``moe_fwd`` forms it: K distinct experts a token, the
    (token, slot) pairs' buffer positions in token order, slot and local."""
    E_loc = E_loc or E
    gen = torch.Generator().manual_seed(seed)
    eid = torch.rand((T, E), generator=gen).argsort(-1)[:, :K].reshape(T * K)
    onehot = (torch.arange(E)[:, None] == eid).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot).sum(0) - 1
    local = (eid >= first) & (eid < first + E_loc) & (pos < C)
    slot = torch.where(local, (eid - first) * C + pos, E_loc * C)
    return slot, local


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_gather_equals_index_copy(dtype):
    T, E, K, C, D = 40, 6, 2, 9, 24
    slot, local = _pairs(T, E, K, C, first=2, E_loc=3)
    assert not local.all()
    xf = torch.randn((T, D)).to(DTYPES[dtype])
    xf[3] = -0.0
    tok = torch.arange(T * K) // K
    want = xf.new_zeros((3 * C + 1, D)).index_copy_(0, slot, xf[tok])[: 3 * C]
    src = mlp._source_map(slot, K, 3 * C)
    assert src.dtype == torch.int32 and src.shape == (3 * C + 1,)
    assert torch.equal(src[:-1] >= 0, torch.zeros(3 * C, dtype=torch.bool).index_fill_(
        0, slot[local], True))
    got = moe_dispatch.moe_gather_plain(xf, src[:-1])
    assert torch.equal(got, want)
    assert torch.equal(ops.moe_gather(xf, src[:-1]), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_combine_equals_reference_expression(dtype):
    T, E, K, C, D = 40, 6, 3, 9, 24
    dt = DTYPES[dtype]
    slot, local = _pairs(T, E, K, C, first=0, E_loc=4)
    assert not local.all()
    eout = torch.randn((4 * C, D)).to(dt)
    # a token whose first pair is kept and whose second is not: a -0.0
    # first product, then the +0.0 of the pair that is not kept
    t = next(t for t in range(T) if local[t * K] and not local[t * K + 1])
    eout[slot[t * K]] = -0.0
    w = torch.softmax(torch.randn((T, K)), -1)
    wflat = w.reshape(T * K).to(dt)
    flat = torch.cat([eout, eout.new_zeros((1, D))])
    contrib = (flat[slot] * (wflat * local.to(dt))[:, None]).reshape(T, K, D)
    want = contrib[:, 0]
    for k in range(1, K):
        want = want + contrib[:, k]
    got = moe_dispatch.moe_combine_plain(eout, slot, w.to(dt), local)
    assert torch.equal(got, want)
    assert torch.equal(ops.moe_combine(eout, slot, w.to(dt), local), want)


def test_wrappers_refuse_autograd():
    slot, local = _pairs(8, 4, 2, 5)
    xf = torch.randn((8, 16), requires_grad=True)
    with pytest.raises(RuntimeError, match="moe_gather kernel has no backward"):
        ops.moe_gather(xf, mlp._source_map(slot, 2, 20)[:-1])
    eout = torch.randn((20, 16), requires_grad=True)
    with pytest.raises(RuntimeError, match="moe_combine kernel has no backward"):
        ops.moe_combine(eout, slot, torch.rand((8, 2)), local)
    with torch.no_grad():  # outside grad mode the inputs may carry requires_grad
        ops.moe_gather(xf, mlp._source_map(slot, 2, 20)[:-1])


def test_kernel_wrappers_need_a_hopper_device():
    slot, local = _pairs(8, 4, 2, 5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        moe_dispatch.moe_gather(torch.randn((8, 16)), mlp._source_map(slot, 2, 20)[:-1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        moe_dispatch.moe_combine(torch.randn((20, 16)), slot, torch.rand((8, 2)), local)


@pytest.mark.parametrize("D,dtype,vec", [
    (1536, torch.bfloat16, 16), (4096, torch.bfloat16, 16), (6, torch.bfloat16, 4),
    (4, torch.bfloat16, 8), (6, torch.float32, 8), (7, torch.float32, 4)])
def test_vector_width_follows_the_row(D, dtype, vec):
    t = torch.empty((3, D), dtype=dtype)
    assert moe_dispatch._vec_bytes(D * t.element_size(), t) == vec


def test_odd_bf16_rows_are_refused():
    t = torch.empty((3, 7), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a multiple of 4 bytes"):
        moe_dispatch._vec_bytes(14, t)


@pytest.mark.parametrize("arch", ["granite_moe_3b", "mixtral_8x7b", "moonshot_v1_16b",
                                  "jamba_1_5_large"])
def test_model_forward_kernel_dispatch_equals_reference_dispatch(arch, monkeypatch):
    """The kernel model's logits with the dispatch's kernel path and with the
    reference's inside it, in bf16: equal bit for bit."""
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, impl="kernel", device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator()
                                     .manual_seed(1))}
    got = model.forward(params, batch)
    monkeypatch.setattr(model_module, "moe_fwd",
                        lambda *a, impl: mlp.moe_fwd(*a, impl="reference"))
    assert torch.equal(got, model.forward(params, batch))


# -- on the card ------------------------------------------------------------


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs a CUDA device of compute capability (9, 0)")
    return torch.device("cuda")


def _recorded(monkeypatch):
    """Record the arguments of each ``ops.moe_gather`` and ``ops.moe_combine``
    call, passed on unchanged."""
    seen = {}
    for name in ("moe_gather", "moe_combine"):
        fn = getattr(ops, name)

        def rec(*args, _fn=fn, _name=name):
            seen[_name] = args
            return _fn(*args)
        monkeypatch.setattr(ops, name, rec)
    return seen


# (arch, tokens (B, S), EP (rank, size) or None, the zoo's padded experts):
# granite's prefill layer as the benchmark runs it (40 experts, C = 8,192), a
# D = 4096 layer, a token count no block divides, an EP rank
CARD_CASES = [("granite_moe_3b", (16, 2048), None, False),
              ("mixtral_8x7b", (2, 1024), None, True),
              ("granite_moe_3b", (1, 1001), None, True),
              ("granite_moe_3b", (2, 1024), (2, 4), True)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch,tokens,ep,padded", CARD_CASES, ids=lambda c: str(c))
def test_card_kernels_equal_plain(hopper, arch, tokens, ep, padded, dtype, monkeypatch):
    cfg, p, x = _layer(arch, DTYPES[dtype], get_config(arch).capacity_factor,
                       device=hopper, tokens=tokens, smoke=False, padded=padded, skew=0.5)
    ctx, p = _ep_rank(monkeypatch, p, ep, hopper)
    want = mlp.moe_fwd(cfg, ctx, p, x)
    seen = _recorded(monkeypatch)
    n = moe_dispatch.moe_gather.launches, moe_dispatch.moe_combine.launches
    got = mlp.moe_fwd(cfg, ctx, p, x, impl="kernel")
    torch.cuda.synchronize()
    assert (moe_dispatch.moe_gather.launches - n[0],
            moe_dispatch.moe_combine.launches - n[1]) == (1, 1)
    assert torch.equal(got, want)
    xf, src = seen["moe_gather"]
    assert torch.equal(moe_dispatch.moe_gather(xf, src),
                       moe_dispatch.moe_gather_plain(xf, src))
    eout, slot, w, local = seen["moe_combine"]
    assert torch.equal(moe_dispatch.moe_combine(eout, slot, w, local),
                       moe_dispatch.moe_combine_plain(eout, slot, w, local))
    # kept rows, empty rows and dropped (or remote) pairs
    assert (src < 0).any() and (src >= 0).any() and not local.all()


@pytest.mark.card
def test_card_granite_forward_equals_reference_dispatch(hopper, monkeypatch):
    cfg = dataclasses.replace(get_config("granite_moe_3b"), n_experts_padded=0)
    model = Model(cfg, impl="kernel", device=hopper)
    gen = torch.Generator(device=hopper).manual_seed(0)
    params = model.init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab, (16, 2048), generator=gen,
                                     device=hopper)}
    n = moe_dispatch.moe_gather.launches, moe_dispatch.moe_combine.launches
    with torch.no_grad():
        got = model.forward(params, batch)
        torch.cuda.synchronize()
        assert (moe_dispatch.moe_gather.launches - n[0],
                moe_dispatch.moe_combine.launches - n[1]) == (cfg.n_layers,) * 2
        monkeypatch.setattr(model_module, "moe_fwd",
                            lambda *a, impl: mlp.moe_fwd(*a, impl="reference"))
        assert torch.equal(got, model.forward(params, batch))
