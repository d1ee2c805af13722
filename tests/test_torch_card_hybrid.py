"""On the card (marked ``card``; elsewhere they skip): granite-4.0-h-small at
its published widths.

- Its first pipeline stage (20 of its 40 layers) runs 18 K3, 18 fused
  convs, 2 K1, 20 ``moe_gather`` and ``moe_combine`` and 18
  ``skip_gated_norm`` launches a forward.
- That stage's logits with the Mamba-2 mixer's fused conv kernel
  (``kernels/causal_conv.py``) equal those with the conv routed to the
  plain version (the kernel alone: ``test_torch_card_kernels.py``).
- Cut to one period and run in float32, its logits agree with the
  benchmark's plain reference (``port_bench/reference/hybrid.py``) on the
  benchmark's weights, with ``dt_bias`` and ``A_log`` as Mamba-2 draws them
  so that state crosses K3's chunks."""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from card_cases import mamba2_dt_A  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_dispatch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import skip_gated_norm as sgn  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "port_bench"
# stage one of granite-4.0-h-small on two H100s: layers 0-19, two whole periods
STAGE = dataclasses.replace(get_config("granite_4_0_h_small"), n_layers=20)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs a CUDA device of compute capability (9, 0)")
    return torch.device("cuda")


@pytest.mark.card
def test_card_granite_cell_launches(hopper):
    cfg = STAGE
    model = Model(cfg, impl="kernel", device=hopper)
    params = model.init(torch.Generator(device=hopper).manual_seed(3))
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, 2048), device=hopper)}
    counters = (ssd.ssd_scan, cc.causal_conv, fa.flash_attention, moe_dispatch.moe_gather,
                moe_dispatch.moe_combine, sgn.skip_gated_norm)
    before = [c.launches for c in counters]
    with torch.inference_mode():
        logits = model.forward(params, batch)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [18, 18, 2, 20, 20, 18]
    assert torch.isfinite(logits).all()


@pytest.mark.card
def test_card_granite_stage_logits_equal_plain_conv(hopper, monkeypatch):
    cfg = STAGE
    model = Model(cfg, impl="kernel", device=hopper)
    gen = torch.Generator(device=hopper).manual_seed(6)
    params = model.init(gen)
    for block in params["blocks"]:  # the init's zero biases would hide a dropped bias
        if "ssm" in block:
            for leaf in block["ssm"]["conv_bias"].values():
                leaf["b"].normal_(generator=gen)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 2048), generator=gen, device=hopper)}
    n = cc.causal_conv.launches
    with torch.inference_mode():
        got = model.forward(params, batch)
        assert cc.causal_conv.launches - n == 18
        monkeypatch.setattr(ops, "causal_conv", cc.causal_conv_plain)
        want = model.forward(params, batch)
    assert torch.equal(got, want)


@pytest.mark.card
def test_card_granite_period_float32_matches_the_reference(hopper):
    """One period (layers 0-9: attention at 5) at the published widths, in
    float32 on the kernel path, against the float32 reference on the same
    weights: the port's equations at full width.  The embedding is drawn
    at 1/12 of the benchmark's scale, so that granite's embedding
    multiplier of 12 does not make every greedy answer the prompt's own
    token; dt_bias and A_log as Mamba-2 draws them (dt in [1e-3, 1e-1], A
    in [1, 16]), so that many heads keep state across a chunk of 128.  On
    an H100 the logits read a relative RMS error of 8.5e-4 and no greedy
    token flipped; with K3 replaced by a scan that drops the carry between
    chunks, 0.63 and 81%."""
    sys.path.append(str(BENCH))
    import check
    import inputs

    cfg = dataclasses.replace(STAGE, n_layers=10, dtype="float32")
    port = dict({f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
                head_dim=cfg.hd)
    model = Model(cfg, impl="kernel", device=hopper)
    gen = torch.Generator(device=hopper).manual_seed(4)
    params = inputs.draw_weights(model, gen)
    params["embed"]["w"].div_(cfg.embedding_multiplier)
    for block in params["blocks"]:
        if "ssm" in block:
            dt_bias, A_log = mamba2_dt_A(gen, block["ssm"]["dt_bias"].shape)
            block["ssm"]["dt_bias"].copy_(dt_bias)
            block["ssm"]["A_log"].copy_(A_log)
    tokens = inputs.token_pool(gen, cfg.vocab, 2048).view(1, 2048)
    ref = check.reference_module({"reference": "hybrid"})
    with torch.inference_mode():
        got = model.forward(params, {"tokens": tokens})[0]
        h = ref.hidden(port, params, tokens, ref.Precision("f32"))[0]
        want = ref.logits(port, params, h, ref.Precision("f32"))
    assert ((got - want).norm() / want.norm()).item() < 1e-2
    assert (got.argmax(-1) != want.argmax(-1)).float().mean().item() < 0.01
