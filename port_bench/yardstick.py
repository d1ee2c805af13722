"""The benchmark's fixed arithmetic: the H100's peaks and the operations and
bytes of the work a cell does, counted from the configuration and the shapes.

Nothing here reads the program: a later change to the program cannot move
the yardstick.  The peaks are NVIDIA's data-sheet numbers for one H100 SXM
(dense, no sparsity) at its 700 W limit; a card with a lower
``power.limit`` runs below them, so every result names the card's limit.
"""
from __future__ import annotations

import math

PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def _layer_matmul_params(m: dict) -> int:
    """Weights one token multiplies by in one layer: attention's four
    projections and the MLP, or for an MoE layer the router and its top-k
    experts (not the capacity rows a dispatch computes)."""
    d, hd = m["d_model"], m["head_dim"]
    attn = d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    if m.get("n_experts", 0):
        mlp = d * m["n_experts"] + m["top_k"] * 3 * d * m["d_ff_expert"]
    else:
        mlp = 3 * d * m["d_ff"]
    return attn + mlp


def matmul_params(m: dict) -> int:
    """Weights one token multiplies by in a forward pass: every layer and
    the head (the embedding is a lookup)."""
    return m["n_layers"] * _layer_matmul_params(m) + m["d_model"] * m["vocab"]


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal row set of length ``s`` attends over."""
    return s * (s + 1) // 2


def attention_flops(batch: int, heads: int, seq: int, head_dim: int) -> float:
    """Causal attention's QK^T and PV products: 4 FLOPs per pair and head
    dimension."""
    return 4.0 * batch * heads * head_dim * causal_pairs(seq)


def attention_bytes(batch: int, heads: int, kv_heads: int, seq: int, head_dim: int,
                    itemsize: int = 2) -> float:
    """q, k and v read once and o written once."""
    return float(itemsize * batch * seq * head_dim * (2 * heads + 2 * kv_heads))


def attention_bound_s(batch: int, heads: int, kv_heads: int, seq: int,
                      head_dim: int) -> float:
    """The least time one bf16 causal attention call can take on the card."""
    return max(attention_flops(batch, heads, seq, head_dim) / PEAK_FLOPS_BF16,
               attention_bytes(batch, heads, kv_heads, seq, head_dim) / PEAK_BYTES)


def prefill_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of a (batch, seq) prefill: 2 per matmul weight and token,
    plus causal attention in every layer."""
    return (2.0 * matmul_params(m) * batch * seq
            + m["n_layers"] * attention_flops(batch, m["n_heads"], seq, m["head_dim"]))


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` percent of ``values`` at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(len(s) * q / 100) - 1)]
