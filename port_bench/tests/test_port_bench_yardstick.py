"""The yardstick's counts against counts made by hand."""
import pytest

import spec
import yardstick

GLM = spec.load_json(spec.ROOT / "port_bench/configs/chatglm3_6b.json")["port"]
GRANITE = spec.load_json(spec.ROOT / "port_bench/configs/granite_moe_3b.json")["port"]


def test_matmul_params_by_hand():
    # chatglm3_6b a layer: q and o 4096 x 4096, k and v 4096 x 256 (2 heads of
    # 128), SwiGLU 3 x 4096 x 13696; 28 layers and the 4096 x 65024 head
    assert yardstick.matmul_params(GLM) == 28 * (2 * 4096 * 4096 + 2 * 4096 * 256
                                                 + 3 * 4096 * 13696) + 4096 * 65024
    assert yardstick.matmul_params(GLM) == 5_976_883_200
    # granite a layer: q and o 1536 x 1536, k and v 1536 x 512, the router
    # 1536 x 40 and 8 experts of 3 x 1536 x 512; the tied head 1536 x 49155
    assert yardstick.matmul_params(GRANITE) == 882_774_528


@pytest.mark.parametrize("m, batch, seq, want", [
    (GLM, 1, 1024, 12_481_409_843_200),
    (GRANITE, 16, 2048, 64_453_802_459_136),
])
def test_prefill_flops_by_hand(m, batch, seq, want):
    assert yardstick.prefill_flops(m, batch, seq) == want


@pytest.mark.parametrize("shape, flops, nbytes, by", [
    # chatglm3_6b's 8k request: 32 q-heads, 2 KV heads of 128
    ((1, 32, 2, 8192, 128), 4 * 32 * 128 * 8192 * 8193 // 2, 2 * 8192 * 128 * (64 + 4),
     "flops"),
    # granite's batch: 16 x 24 q-heads, 8 KV heads of 64, 2048 positions
    ((16, 24, 8, 2048, 64), 4 * 16 * 24 * 64 * 2048 * 2049 // 2,
     2 * 16 * 2048 * 64 * (48 + 16), "flops"),
])
def test_attention_counts_by_hand(shape, flops, nbytes, by):
    b, h, hkv, s, d = shape
    assert yardstick.attention_flops(b, h, s, d) == flops
    assert yardstick.attention_bytes(b, h, hkv, s, d) == nbytes
    t = yardstick.attention_bound_s(*shape)
    assert t == (flops / 989e12 if by == "flops" else nbytes / 3.35e12)


def test_percentile_nearest_rank():
    assert yardstick.percentile(list(range(1, 101)), 95) == 95
    assert yardstick.percentile([3.0, 1.0, 2.0], 95) == 3.0
    assert yardstick.percentile([5.0], 95) == 5.0
