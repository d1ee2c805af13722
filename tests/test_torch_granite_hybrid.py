"""granite-4.0-h-small at SMOKE size: Mamba-2 mixers with conv biases and a
whole-width gated norm beside NoPE attention at its own softmax scale, a MoE
with a shared expert, and granite's embedding, residual and logits
multipliers, through ``Model`` on the CPU against the benchmark's plain
reference (``port_bench/reference/hybrid.py``, loaded as the harness loads
it) on the benchmark's seeded random weights.

Also: prefill then ``decode_step`` through the caches against the full
forward; each field the port added, alone, against the reference, and the
program with that field dropped against it (so that dropping any one
fails); K1's plain version at ``scale=1/128`` against ``chunked_attention``;
and the benchmark's hybrid FLOP count against ``yardstick.prefill_flops`` on
the configurations it already ran."""
import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ArchConfig, get_config  # noqa: E402
from repro_torch.configs.base import PORT_FIELDS  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "port_bench"
if str(BENCH) not in sys.path:  # the harness's modules, as run.py finds them
    sys.path.append(str(BENCH))

import check  # noqa: E402
import inputs  # noqa: E402
import yardstick  # noqa: E402
import yardstick_hybrid  # noqa: E402

REF = check.reference_module({"reference": "hybrid"})
# the fields the port added (SMOKE sets each away from its default)
NEW_FIELDS = PORT_FIELDS
DEFAULTS = {f.name: f.default for f in dataclasses.fields(ArchConfig) if f.name in NEW_FIELDS}


def smoke(**change):
    return dataclasses.replace(get_config("granite_4_0_h_small", smoke=True),
                               dtype="float32", **change)


def port_dict(cfg) -> dict:
    """The configuration as the benchmark's ``port`` section holds it."""
    m = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return dict(m, head_dim=cfg.hd)


def draw(cfg, seed: int = 3, batch: int = 4, seq: int = 48):
    """The benchmark's weights and a batch of prompts for ``cfg``."""
    gen = torch.Generator().manual_seed(seed)
    params = inputs.draw_weights(Model(cfg, impl="reference", device="cpu"), gen)
    tokens = inputs.token_pool(gen, cfg.vocab, batch * seq).view(batch, seq)
    return params, tokens


def program_logits(cfg, params, tokens, impl: str = "kernel"):
    with torch.no_grad():
        return Model(cfg, impl=impl, device="cpu").forward(
            params, {"tokens": tokens})[..., : cfg.vocab]


def reference_logits(cfg, params, tokens, prec: str = "f32"):
    m = port_dict(cfg)
    h = REF.hidden(m, params, tokens, REF.Precision(prec))
    return REF.logits(m, params, h, REF.Precision(prec))


def test_smoke_sets_every_field_the_port_added_and_the_published_pattern():
    cfg, full = get_config("granite_4_0_h_small", smoke=True), get_config("granite_4_0_h_small")
    for name in NEW_FIELDS:
        assert getattr(cfg, name) != DEFAULTS[name], name
    assert cfg.rope_fraction == 0.0 and cfg.shared_expert_ff and cfg.tie_embeddings
    assert [cfg.is_attn_layer(i) for i in range(cfg.n_layers)] == [False, False, True, False]
    assert [i for i in range(full.n_layers) if full.is_attn_layer(i)] == [5, 15, 25, 35]
    assert all(full.is_moe_layer(i) for i in range(full.n_layers))
    assert (full.ssm_heads, full.d_inner, full.ssm_norm_group) == (128, 8192, 8192)
    assert full.attention_multiplier == 1 / 128 and full.logits_scaling == 16.0


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_smoke_forward_matches_the_plain_reference(impl):
    cfg = smoke()
    params, tokens = draw(cfg)
    got = program_logits(cfg, params, tokens, impl)
    want = reference_logits(cfg, params, tokens)
    err = (got - want).abs().max().item()
    assert err < 1e-5 * want.abs().max().item(), err
    # the fp8 control departs from both by far more
    control = reference_logits(cfg, params, tokens, "fp8")
    assert (control - want).abs().max().item() > 100 * err


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_prefill_then_decode_through_the_caches_matches_the_forward(impl):
    cfg = smoke()
    params, tokens = draw(cfg, seed=7, batch=2, seq=48)
    full = program_logits(cfg, params, tokens, impl)
    model = Model(cfg, impl=impl, device="cpu")
    caches = model.init_cache(2, 48)
    steps = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            logits, caches = model.decode_step(params, tokens[:, t], caches, t)
            steps.append(logits[:, : cfg.vocab])
    got = torch.stack(steps, dim=1)
    assert (got - full).abs().max().item() < 1e-5 * full.abs().max().item()


@pytest.mark.parametrize("field", NEW_FIELDS)
def test_each_new_field_alone_against_the_reference(field):
    """Only ``field`` away from its default: the program agrees with the
    reference, and the program without it does not."""
    base = smoke(**DEFAULTS)
    cfg = dataclasses.replace(base, **{field: getattr(smoke(), field)})
    params, tokens = draw(cfg, seed=11)
    want = reference_logits(cfg, params, tokens)
    scale = want.abs().max().item()
    # float32 against float32: the harness's own tolerance (port_bench/tests)
    assert (program_logits(cfg, params, tokens) - want).abs().max().item() < 1e-4 * scale
    dropped = program_logits(base, params, tokens)
    assert (dropped - want).abs().max().item() > 1e-2 * scale, field


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 2, 40, 40, 128), (1, 4, 4, 24, 56, 64)])
def test_k1_plain_at_granite_scale_matches_chunked_attention(shape, causal):
    B, Hq, Hkv, Sq, Sk, D = shape
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(s, generator=gen) for s in
               ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
    got = fa.flash_attention_plain(q, k, v, causal=causal, scale=1 / 128)
    want = chunked_attention(q, k, v, causal=causal, chunk=16, scale=1 / 128)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    # the default scale is 1 / sqrt(D), bit for bit as written before the keyword
    assert torch.equal(fa.flash_attention_plain(q, k, v, causal=causal),
                       fa.flash_attention_plain(q, k, v, causal=causal,
                                                scale=1.0 / math.sqrt(D)))
    assert not torch.allclose(got, fa.flash_attention_plain(q, k, v, causal=causal),
                              atol=1e-3)


@pytest.mark.parametrize("shape", [(1, 512), (16, 2048), (8, 4096)])
@pytest.mark.parametrize("config", ["chatglm3_6b", "granite_moe_3b"])
def test_hybrid_flop_count_equals_the_yardstick_on_the_accepted_configs(config, shape):
    m = json.loads((BENCH / "configs" / f"{config}.json").read_text())["port"]
    assert yardstick_hybrid.prefill_flops(m, *shape) == yardstick.prefill_flops(m, *shape)


def test_hybrid_flop_count_of_the_granite_cell():
    m = json.loads((BENCH / "configs" / "granite_4_0_h_small.json").read_text())["port"]
    per_token = yardstick_hybrid.matmul_params(m)
    # 18 Mamba-2 layers, 2 attention layers, 20 MoE layers with the shared
    # expert, and the tied head
    mamba = 4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096
    attn = 4096 * 128 * (2 * 32 + 2 * 8)
    moe = 4096 * 72 + 10 * 3 * 4096 * 768 + 3 * 4096 * 1536
    assert per_token == 18 * mamba + 2 * attn + 20 * moe + 4096 * 100352
    cbt, per_head, moved = yardstick_hybrid.ssd_scan_work(8, 4096, 128, 64, 128, 128)
    assert cbt == 8 * 32 * 128 * 129 * 128
    assert per_head == 2 * 8 * 128 * 32 * (128 * 129 * 64 + 4 * 128 * 128 * 64)
    flops = yardstick_hybrid.prefill_flops(m, 8, 4096)
    assert flops == (2.0 * per_token * 8 * 4096 + 2 * yardstick.attention_flops(8, 32, 4096, 128)
                     + 18 * (cbt + per_head))
    # bytes bound the kernel at this shape: 1.64 GB of x, dt, B, C and y
    assert moved / yardstick.PEAK_BYTES > (cbt + per_head) / yardstick.PEAK_FLOPS_BF16
    assert yardstick_hybrid.ssd_scan_bound_s(8, 4096, 128, 64, 128, 128) == pytest.approx(
        moved / yardstick.PEAK_BYTES)


def test_gated_norm_group_that_does_not_divide_the_width_raises():
    from repro_torch.models.ssm import ssm_fwd
    from repro_torch.tree import tree_map

    cfg = smoke()
    params = Model(cfg, impl="reference", device="cpu").init(torch.Generator().manual_seed(0))
    p = tree_map(lambda a: a[0], params["blocks"][0]["ssm"])
    half = dataclasses.replace(cfg, ssm_norm_group=cfg.d_inner * 2)
    with pytest.raises(ValueError, match="gated norm"):
        ssm_fwd(half, ParallelCtx.single(), p, torch.zeros(1, 16, cfg.d_model))


def test_conv_bias_shards_with_its_conv():
    from repro_torch.parallel.sharding import P, param_specs

    specs = param_specs(Model(smoke(), impl="reference", device="cpu").param_shapes())
    ssm = specs["blocks"][0]["ssm"]
    assert ssm["conv_bias"]["x"]["b"] == P(None, "model")
    assert ssm["conv_bias"]["B"]["b"] == ssm["conv_bias"]["C"]["b"] == P(None, None)
    assert ssm["conv_x"] == P(None, None, "model")
