"""The benchmark's arithmetic for a stack of mixed layers: attention or a
Mamba-2 mixer in each layer, then a dense MLP or a mixture of experts with
an optional shared expert (``yardstick.py`` counts every layer as
attention plus MLP or MoE, and knows no shared expert or SSM layer).

Counted from the configuration's ``port`` section and the shapes alone, as
``yardstick.py`` counts: 2 FLOPs per matmul weight and token (router,
top-k experts, shared expert, the Mamba-2 projections, the head), causal
attention in the attention layers only, and in each Mamba-2 layer the SSD
scan's operations as its kernel's bound counts them.  On a configuration
without SSM layers or a shared expert the count is ``yardstick.prefill_flops``.
"""
from __future__ import annotations

import yardstick


def is_attention(m: dict, li: int) -> bool:
    """Layer ``li`` mixes with attention (else with Mamba-2)."""
    if not m.get("ssm_state", 0):
        return True
    period = m.get("attn_period", 0)
    return bool(period) and li % period == m.get("attn_offset", 0)


def is_moe(m: dict, li: int) -> bool:
    return m.get("n_experts", 0) > 0 and li % m.get("moe_period", 1) == m.get("moe_offset", 0)


def _ssm_dims(m: dict) -> tuple[int, int, int, int]:
    """(inner width, SSD heads, head dim, state width) of a Mamba-2 layer."""
    di = m.get("ssm_expand", 2) * m["d_model"]
    p = m.get("ssm_head_dim", 64)
    return di, di // p, p, m["ssm_state"]


def _layer_matmul_params(m: dict, li: int) -> int:
    """Weights one token multiplies by in layer ``li``: the mixer's
    projections, and the MLP or the router, top-k experts and shared expert."""
    d = m["d_model"]
    if is_attention(m, li):
        mix = d * m["head_dim"] * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    else:
        di, h, _, n = _ssm_dims(m)
        mix = d * (2 * di + 2 * n + h) + di * d  # wx, wz, wB, wC, wdt; wo
    if is_moe(m, li):
        ffn = d * m["n_experts"] + m["top_k"] * 3 * d * m["d_ff_expert"]
        ffn += 3 * d * m.get("shared_expert_ff", 0)
    else:
        ffn = 3 * d * m.get("d_ff", 0)
    return mix + ffn


def matmul_params(m: dict) -> int:
    return (sum(_layer_matmul_params(m, li) for li in range(m["n_layers"]))
            + m["d_model"] * m["vocab"])


def ssd_scan_work(batch: int, seq: int, heads: int, head_dim: int, state: int,
                  chunk: int, bf16: bool = True) -> tuple[float, float, float]:
    """One SSD scan of x (batch, seq, heads, head_dim) with B and C of width
    ``state`` at chunk ``q = min(chunk, seq)``, as ``chip_smoke.py``'s K3
    bound counts it: (C B^T on each chunk's causal pairs once per (b,
    chunk), all heads sharing one B and C; the per-head products M x, C
    state and the state update, which the bf16 kernel runs as two
    tensor-core passes and so count twice; the bytes of x, B and C read
    once in the model's dtype, dt and A in float32, and y written once in
    float32)."""
    q = min(chunk, seq)
    chunks = seq // q
    cbt = batch * chunks * q * (q + 1) * state
    per_head = batch * heads * chunks * (q * (q + 1) * head_dim + 4 * q * state * head_dim)
    item = 2 if bf16 else 4
    moved = (batch * seq * (item * (heads * head_dim + 2 * state) + 4 * heads
                            + 4 * heads * head_dim) + 4 * heads)
    return float(cbt), float((2 if bf16 else 1) * per_head), float(moved)


def ssd_scan_bound_s(*shape, bf16: bool = True) -> float:
    """The least time one K3 call of ``shape`` (``ssd_scan_work``'s) can take
    on the card: its operations at the bf16 peak or its bytes at HBM's."""
    cbt, per_head, moved = ssd_scan_work(*shape, bf16=bf16)
    return max((cbt + per_head) / yardstick.PEAK_FLOPS_BF16, moved / yardstick.PEAK_BYTES)


def _scan_shape(m: dict, batch: int, seq: int) -> tuple:
    _, h, p, n = _ssm_dims(m)
    return batch, seq, h, p, n, m.get("ssm_chunk", 128)


def prefill_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of a (batch, seq) prefill: 2 per matmul weight and token,
    causal attention in the attention layers, the SSD scan in the others."""
    layers = range(m["n_layers"])
    n_attn = sum(is_attention(m, li) for li in layers)
    n_ssm = m["n_layers"] - n_attn
    flops = (2.0 * matmul_params(m) * batch * seq
             + n_attn * yardstick.attention_flops(batch, m["n_heads"], seq, m["head_dim"]))
    if n_ssm:
        cbt, per_head, _ = ssd_scan_work(*_scan_shape(m, batch, seq),
                                         bf16=m.get("dtype", "bfloat16") == "bfloat16")
        flops += n_ssm * (cbt + per_head)
    return flops
