"""The capacity dispatch's gather and combine kernels (``kernels/
moe_dispatch.py``, ``csrc/moe_dispatch.cu``) and ``moe_fwd(impl="kernel")``,
which moves its rows with them.

On the CPU the wrappers take the plain versions: ``moe_fwd(impl="kernel")``
equals ``impl="reference"`` bit for bit (capacity that drops pairs, an
expert-parallel rank whose remote pairs go to the overflow slot, f32 and
bf16), the plain gather and combine equal the reference's expressions, and
the wrappers refuse autograd-tracked inputs.  The test marked ``card`` runs
a whole granite_moe_3b forward on a capability-(9, 0) device against the
same model with the reference's dispatch; elsewhere it skips.  The kernels
against their plain versions on the card: ``test_torch_card_kernels.py``.
The layers are drawn by ``card_cases.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from card_cases import dispatch_layer, ep_rank  # noqa: E402
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


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch,cf,ep", CASES, ids=lambda c: str(c))
def test_kernel_dispatch_equals_reference(arch, cf, ep, dtype, monkeypatch):
    cfg, p, x = dispatch_layer(arch, DTYPES[dtype], cf)
    ctx, p = ep_rank(p, ep)
    # a rank's combine alone: its partial sum before the all_reduce
    monkeypatch.setattr(ParallelCtx, "psum_ep", lambda self, x: x)
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
