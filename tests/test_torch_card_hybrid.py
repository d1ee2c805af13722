"""On the card (marked ``card``; elsewhere they skip): K1's softmax scale, and
granite-4.0-h-small at its published widths.

- K1 at its default scale through the scaled entry equals, bit for bit, the
  entry at 1 / sqrt(D) that K1 had before the scale was a keyword, and at
  granite's 1/128 it agrees with its plain version.
- A whole chatglm3_6b and granite_moe_3b forward (the benchmark's two
  configurations, cut in depth) with K1 called through that older entry
  equals the forward as it runs: the new fields at their defaults change no
  logit.
- The Mamba-2 mixer's fused conv kernel (``kernels/causal_conv.py``) equals
  its plain version bit for bit: at the benchmark cell's mixer (8 x 4096,
  x 8192 wide, B and C 128, 4 taps, biases) in bfloat16 and float32, at
  mamba2_130m's (no bias), and at ragged shapes (short sequences, other tap
  counts, a row count no block divides).  A granite-4.0-h-small stage's
  logits with the kernel equal those with the conv routed to the plain
  version.
- granite-4.0-h-small's first pipeline stage (20 of its 40 layers) runs 18
  K3, 18 fused convs, 2 K1 and 20 ``moe_gather`` and ``moe_combine``
  launches a forward; cut
  to one period and run in float32, its logits agree with the benchmark's
  plain reference (``port_bench/reference/hybrid.py``) on the benchmark's
  weights, with ``dt_bias`` and ``A_log`` as Mamba-2 draws them so that state
  crosses K3's chunks."""
import ctypes
import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_dispatch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "port_bench"
# stage one of granite-4.0-h-small on two H100s: layers 0-19, two whole periods
STAGE = dataclasses.replace(get_config("granite_4_0_h_small"), n_layers=20)
FA_TOL = (1e-2, 1e-2)  # chip_smoke.FA_TOL's bf16 tolerance


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs a CUDA device of compute capability (9, 0)")
    return torch.device("cuda")


def _old_entry(q, k, v, *, causal: bool = True):
    """K1 through ``repro_flash_attention_fwd``, the entry at 1 / sqrt(D)."""
    fn = build.load("flash_attention").repro_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    B, Hq, Sq, D = q.shape
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, B, Hq, k.shape[1],
            Sq, k.shape[2], D, int(causal), torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return out


@pytest.mark.card
@pytest.mark.parametrize("shape", [(8, 32, 8, 4096, 128), (2, 32, 16, 1024, 64),
                                   (2, 16, 16, 1024, 256), (1, 8, 2, 200, 128)])
def test_card_k1_default_scale_bit_for_bit_and_granite_scale(hopper, shape):
    B, Hq, Hkv, S, D = shape
    gen = torch.Generator(device=hopper).manual_seed(1)
    q, k, v = (torch.randn(s, generator=gen, device=hopper).bfloat16()
               for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    assert torch.equal(fa.flash_attention(q, k, v), _old_entry(q, k, v))
    assert torch.equal(fa.flash_attention(q, k, v, scale=1.0 / math.sqrt(D)),
                       _old_entry(q, k, v))
    if B * S <= 4096:  # the plain version's scores fit
        got = fa.flash_attention(q, k, v, scale=1 / 128)
        want = fa.flash_attention_plain(q, k, v, scale=1 / 128)
        torch.testing.assert_close(got, want, atol=FA_TOL[0], rtol=FA_TOL[1])


@pytest.mark.card
@pytest.mark.parametrize("arch,layers,tokens", [("chatglm3_6b", 2, (1, 4096)),
                                                ("granite_moe_3b", 4, (16, 2048))])
def test_card_accepted_configs_logits_unchanged(hopper, arch, layers, tokens, monkeypatch):
    port = json.loads((BENCH / "configs" / f"{arch}.json").read_text())["port"]
    cfg = ArchConfig(name=arch, **dict(port, n_layers=layers))
    model = Model(cfg, impl="kernel", device=hopper)
    gen = torch.Generator(device=hopper).manual_seed(2)
    params = model.init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab, tokens, generator=gen, device=hopper)}
    with torch.inference_mode():
        got = model.forward(params, batch)
        monkeypatch.setattr(ops, "flash_attention",
                            lambda q, k, v, *, causal, scale: _old_entry(q, k, v, causal=causal))
        assert torch.equal(got, model.forward(params, batch))


@pytest.mark.card
def test_card_granite_cell_launches(hopper):
    cfg = STAGE
    model = Model(cfg, impl="kernel", device=hopper)
    params = model.init(torch.Generator(device=hopper).manual_seed(3))
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, 2048), device=hopper)}
    counters = (ssd.ssd_scan, cc.causal_conv, fa.flash_attention, moe_dispatch.moe_gather,
                moe_dispatch.moe_combine)
    before = [c.launches for c in counters]
    with torch.inference_mode():
        logits = model.forward(params, batch)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [18, 18, 2, 20, 20]
    assert torch.isfinite(logits).all()


# (B, S, channels of each input, taps, bias): the benchmark cell's mixer,
# mamba2_130m's prefill (inner width 1536 padded to 2048, no bias), then
# sequences shorter than the taps, a sequence no block of 256 rows divides,
# one input alone, and the largest tap count
CONV_CASES = [(8, 4096, (8192, 128, 128), 4, True), (4, 4096, (2048, 128, 128), 4, False),
              (3, 3, (64, 16, 16), 4, True), (2, 1, (8, 8), 2, False),
              (3, 1001, (520, 24, 136), 3, True), (1, 300, (256,), 8, False),
              (2, 513, (32, 16, 16), 1, True)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,S,widths,K,bias", CONV_CASES, ids=str)
def test_card_causal_conv_equals_plain(hopper, B, S, widths, K, bias, dtype):
    gen = torch.Generator(device=hopper).manual_seed(5)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=hopper).to(dtype)

    convs = []
    for C in widths:
        x = draw(B, S, C)
        x[:, ::7, ::3] = 0.0  # exact zeros: signed zero products
        convs.append((x, draw(K, C), draw(C) if bias else None))
    n = cc.causal_conv.launches
    got = cc.causal_conv(*convs)
    torch.cuda.synchronize()
    assert cc.causal_conv.launches - n == 1
    for y, want in zip(got, cc.causal_conv_plain(*convs)):
        assert y.dtype == dtype and torch.equal(y, want)


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
            ssm = block["ssm"]
            u = torch.rand(ssm["dt_bias"].shape, generator=gen, device=hopper)
            dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
            ssm["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
            A = torch.rand(ssm["A_log"].shape, generator=gen, device=hopper) * 15.0 + 1.0
            ssm["A_log"].copy_(torch.log(A))
    tokens = inputs.token_pool(gen, cfg.vocab, 2048).view(1, 2048)
    ref = check.reference_module({"reference": "hybrid"})
    with torch.inference_mode():
        got = model.forward(params, {"tokens": tokens})[0]
        h = ref.hidden(port, params, tokens, ref.Precision("f32"))[0]
        want = ref.logits(port, params, h, ref.Precision("f32"))
    assert ((got - want).norm() / want.norm()).item() < 1e-2
    assert (got.argmax(-1) != want.argmax(-1)).float().mean().item() < 0.01
