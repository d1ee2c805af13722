"""The port's MoE programs on gloo ranks on the CPU against the single device,
in f32.  The execution program (``spmd.tp_forward``: attention and the
shared expert Megatron-sharded, the experts split over the ranks, each rank
running the capacity dispatch for its own at ``first = rank * E_loc`` and
one all_reduce over the expert axis) gives the single-device logits to
relative RMS error 1e-5, the bound of ``test_torch_tp.py``; capacity is
counted from the global token count, so the ranks' dropped pairs sum to the
single device's.  The expert-parallel verification formulation
(``moe_ep_fwd``, each rank its slice of the dense mask and of the expert
stacks) summed over gloo ranks equals ``moe_dense_fwd`` on one device."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.mlp import moe_dense_fwd, moe_ep_fwd, moe_init, record_routing  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402
from repro_torch.parallel.sharding import P, param_specs, shard_params  # noqa: E402

REL_RMS = 1e-5
SEED = 3


def _cfg(arch, tp, **change):
    """f32 SMOKE config with KV heads and experts padded to the TP degree
    (as CONFIG pads granite's 40 experts to 48 for 16-way EP)."""
    cfg = get_config(arch, smoke=True)
    pad = -(-cfg.experts // tp) * tp
    return dataclasses.replace(
        cfg, dtype="float32", n_kv_heads_padded=max(tp, cfg.kv_heads),
        n_experts_padded=pad if pad != cfg.n_experts else cfg.n_experts_padded, **change)


def _rel(got, want):
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch,change", [
    ("granite_moe_3b", {}),  # padded experts (5 of 6, or of 8 at tp 4); drops
    ("moonshot_v1_16b", {}),  # the shared expert's own psum
    ("mixtral_8x7b", {"capacity_factor": 0.5}),  # capacity drops pairs
], ids=["granite_moe_3b", "moonshot_v1_16b", "mixtral_8x7b-drops"])
def test_moe_tp_logits_equal_single_device(arch, change, tp):
    cfg = _cfg(arch, tp, **change)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    model = Model(cfg, impl="reference", device="cpu")
    params = model.init(torch.Generator().manual_seed(SEED))
    with torch.inference_mode(), record_routing() as routing:
        want = model.forward(params, {"tokens": tokens})
    dropped = sum(int(r["dropped"]) for r in routing)
    ranks = spmd.run(spmd.tp_forward, tp, (cfg, SEED, tokens, "reference", "cpu"),
                     timeout=300)
    got = torch.cat([r["logits"] for r in ranks], dim=-1)
    assert got.shape == want.shape
    assert _rel(got, want) <= REL_RMS
    assert sum(r["dropped"] for r in ranks) == dropped
    assert dropped > 0 or not change


def _ep_rank(rank, world, cfg, p, x):
    ctx = ParallelCtx(ep_axis="model", ep_size=world,
                      rank=torch.tensor(rank, dtype=torch.int64))
    specs = {"router": {"w": P(None, None)}, "wg": P("model", None, None),
             "wu": P("model", None, None), "wo": P("model", None, None)}
    mine = shard_params(p, specs, rank, world, axis="model")
    with torch.inference_mode():
        return moe_ep_fwd(cfg, ctx, mine, x).clone()


@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("arch", ["granite_moe_3b", "mixtral_8x7b"])
def test_moe_ep_formulation_equals_dense_on_gloo_ranks(arch, ep):
    cfg = _cfg(arch, ep)
    p = moe_init(torch.Generator().manual_seed(SEED), cfg, dtype=torch.float32)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        want = moe_dense_fwd(cfg, ParallelCtx.single(), p, x)
    for got in spmd.run(_ep_rank, ep, (cfg, p, x), timeout=300):
        assert _rel(got, want) <= REL_RMS


def test_expert_stacks_shard_over_experts():
    cfg = _cfg("moonshot_v1_16b", 4)
    params = Model(cfg, impl="reference", device="cpu").init(torch.Generator().manual_seed(0))
    specs = param_specs(params)
    moe = specs["blocks"][0]["moe"]
    assert moe["router"]["w"] == P(None, None, None)
    assert moe["wg"] == moe["wu"] == moe["wo"] == P(None, "model", None, None)
    assert moe["shared"]["wg"]["w"] == P(None, None, "model")
    assert moe["shared"]["wo"]["w"] == P(None, "model", None)
    shard = shard_params(params, specs, 1, 4)
    wg = params["blocks"][0]["moe"]["wg"]
    e = cfg.experts // 4
    assert torch.equal(shard["blocks"][0]["moe"]["wg"], wg[:, e:2 * e])
