"""Each reference against the program on the CPU at a small size: the same
weights and prompts through ``reference/decoder.py`` and the port's
``Model.forward`` in float32 give the same logits, and the fp8 control
departs from them."""
import pytest
import torch

import check
import inputs
from tiny import tiny_cell

CELLS = ["chatglm3_6b.prefill_mix", "granite_moe_3b.prefill_batch16"]


def _program_and_reference(workload, impl):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import Model

    cell = tiny_cell(workload)
    m = dict(cell.config["port"], dtype="float32")
    cfg = ArchConfig(name="tiny", **m)
    model = Model(cfg, impl=impl, device="cpu")
    gen = torch.Generator().manual_seed(3)
    params = inputs.draw_weights(model, gen)
    tokens = inputs.token_pool(gen, cfg.vocab, 4 * 48).view(4, 48)
    with torch.no_grad():
        got = model.forward(params, {"tokens": tokens})[..., : cfg.vocab]
    ref = check.reference_module(cell.config)
    h = ref.hidden(m, params, tokens, ref.Precision("f32"))
    want = ref.logits(m, params, h, ref.Precision("f32"))
    h8 = ref.hidden(m, params, tokens, ref.Precision("fp8"))
    control = ref.logits(m, params, h8, ref.Precision("fp8"))
    return got, want, control


@pytest.mark.parametrize("impl", ["reference", "kernel"])
@pytest.mark.parametrize("workload", CELLS)
def test_reference_matches_the_program_in_float32(workload, impl):
    got, want, control = _program_and_reference(workload, impl)
    err = (got - want).abs().max().item()
    assert err < 1e-4 * want.abs().max().item(), err
    assert (control - want).abs().max().item() > 100 * err


def test_capacity_drops_as_the_program():
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import mlp
    from repro_torch.parallel.ctx import ParallelCtx

    cell = tiny_cell("granite_moe_3b.prefill_batch16")
    m = dict(cell.config["port"], dtype="float32", capacity_factor=0.5)
    cfg = ArchConfig(name="tiny", **m)
    gen = torch.Generator().manual_seed(5)
    p = {"router": {"w": torch.randn(64, 5, generator=gen)},
         "wg": torch.randn(5, 64, 32, generator=gen) / 8,
         "wu": torch.randn(5, 64, 32, generator=gen) / 8,
         "wo": torch.randn(5, 32, 64, generator=gen) / 6}
    x = torch.randn(2, 24, 64, generator=gen)
    with mlp.record_routing() as routing:
        got = mlp.moe_fwd(cfg, ParallelCtx.single(), p, x)
    ref = check.reference_module(cell.config)
    with ref.no_tf32():
        want, dropped = ref.moe(m, p, x, ref.Precision("f32"))
    assert dropped == int(routing[0]["dropped"]) > 0
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
