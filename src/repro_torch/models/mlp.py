"""Feed-forward blocks: dense GLU/GELU MLPs and capacity-based top-k MoE with
expert parallelism.

MoE dispatch is sort-free (cumsum positions + scatter into per-expert
capacity buffers), deterministic-shape, and EP-aware: each rank materializes
only its local experts' buffers; the per-token combine is a partial sum
discharged by one all_reduce over the expert axis.  Padded experts (e.g.
granite 40 -> 48) are masked out in the router.  The expert products are
``torch.bmm``/``torch.einsum``, as they are ``jnp.einsum`` outside any
kernel in the JAX package.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.scope import span

from .modules import ACTS, _init, dynamic_slice_in_dim, linear, linear_init, silu


def mlp_init(generator, cfg, d_ff: int, *, stacked: tuple = (), dtype=torch.bfloat16):
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {
            "wg": linear_init(generator, cfg.d_model, d_ff, dtype=dtype, stacked=stacked),
            "wu": linear_init(generator, cfg.d_model, d_ff, dtype=dtype, stacked=stacked),
            "wo": linear_init(generator, d_ff, cfg.d_model, dtype=dtype, stacked=stacked),
        }
    return {
        "wi": linear_init(generator, cfg.d_model, d_ff, dtype=dtype, stacked=stacked),
        "wo": linear_init(generator, d_ff, cfg.d_model, dtype=dtype, stacked=stacked),
    }


def mlp_fwd(cfg, ctx: ParallelCtx, p, x, *, decode: bool = False):
    """Dense MLP: column-parallel in, row-parallel out.  ``decode``: the
    serving step's silu, rounded as the reference rounds it there
    (``modules.silu``)."""
    if cfg.mlp_act == "swiglu":
        h = (silu if decode else F.silu)(linear(p["wg"], x)) * linear(p["wu"], x)
    elif cfg.mlp_act == "geglu":
        h = ACTS["gelu"](linear(p["wg"], x)) * linear(p["wu"], x)
    else:
        h = ACTS[cfg.mlp_act](linear(p["wi"], x))
    y = linear(p["wo"], h)
    return ctx.sp_enter(y)


# ---------------------------------------------------------------------------
# Mixture of Experts


@torch.library.custom_op("repro_torch::top_k", mutates_args=())
def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the ``k`` largest values in
    descending order and their indices, ties broken by the lower index (a
    stable descending sort: ``torch.topk`` promises no order among ties,
    on either device).  The verifier's tracer lowers it as ``lax.top_k``
    traces: one ``top_k`` node for each output."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


@top_k.register_fake
def _top_k_fake(x, k):
    shape = (*x.shape[:-1], k)
    return x.new_empty(shape), x.new_empty(shape, dtype=torch.int64)


def _top_k_setup(ctx, inputs, output):
    ctx.save_for_backward(output[1])
    ctx.n = inputs[0].shape[-1]


def _top_k_backward(ctx, g_vals, g_idx):
    """``lax.top_k``'s gradient: each value's cotangent at its index."""
    (idx,) = ctx.saved_tensors
    gx = g_vals.new_zeros((*g_vals.shape[:-1], ctx.n))
    return gx.scatter(-1, idx, g_vals), None


top_k.register_autograd(_top_k_backward, setup_context=_top_k_setup)


def moe_init(generator, cfg, *, stacked: tuple = (), dtype=torch.bfloat16):
    E, D, F_ = cfg.experts, cfg.d_model, cfg.d_ff_expert
    p = {
        "router": {"w": _init(generator, (*stacked, D, E), 1.0 / math.sqrt(D),
                              torch.float32)},
        "wg": _init(generator, (*stacked, E, D, F_), 1.0 / math.sqrt(D), dtype),
        "wu": _init(generator, (*stacked, E, D, F_), 1.0 / math.sqrt(D), dtype),
        "wo": _init(generator, (*stacked, E, F_, D), 1.0 / math.sqrt(F_), dtype),
    }
    if cfg.shared_expert_ff:
        p["shared"] = mlp_init(generator, cfg, cfg.shared_expert_ff, stacked=stacked,
                               dtype=dtype)
    return p


def moe_capacity(cfg, tokens: int) -> int:
    return int(math.ceil(tokens * cfg.top_k / cfg.experts * cfg.capacity_factor))


# the routing of each capacity dispatch while ``record_routing`` is active
_ROUTING: Optional[list] = None


@contextmanager
def record_routing():
    """Collect the routing of every ``moe_fwd`` call inside the block, in
    call order: a dict per call with ``idx``, the top-k expert ids (T, K),
    and ``dropped``, the (token, slot) pairs of this rank's experts that
    capacity dropped (a 0-d tensor; the ranks' counts sum to the single
    device's).  Both stay on the device: recording adds no host sync."""
    global _ROUTING
    prev, _ROUTING = _ROUTING, []
    try:
        yield _ROUTING
    finally:
        _ROUTING = prev


def _route(cfg, p, xf):
    """Router: f32 logits, padded experts masked to -1e30, softmax, top-k
    and the top-k weights renormalized.  Returns (w (T, K) f32, idx (T, K))."""
    E = cfg.experts
    logits = xf.float() @ p["router"]["w"]
    if cfg.n_experts_padded and cfg.n_experts_padded > cfg.n_experts:
        pad_mask = torch.arange(E, device=xf.device) >= cfg.n_experts
        logits = torch.where(pad_mask[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, cfg.top_k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renormalize top-k
    return w, idx


def _source_map(slot, top_k: int, rows: int):
    """(rows + 1,) int32: entry r is the token whose pair took buffer row r,
    or -1 for an empty row; entry ``rows`` is the overflow, which several
    dropped or remote pairs write in no fixed order on CUDA and nothing
    reads."""
    tok = torch.arange(slot.numel(), dtype=torch.int32, device=slot.device) // top_k
    return torch.full((rows + 1,), -1, dtype=torch.int32,
                      device=slot.device).index_copy_(0, slot, tok)


def moe_fwd(cfg, ctx: ParallelCtx, p, x, *, impl: str = "reference"):
    """Top-k routed MoE, the capacity dispatch (the execution path).
    x: (B, S, D), replicated across the expert axis.

    Each (token, slot) pair takes the next free position of its expert's
    buffer of C = ``moe_capacity`` rows, in token order (cumsum positions);
    a pair past C is dropped.  This rank computes its experts ``[first,
    first + E_loc)`` (``first = rank * E_loc``) and sends everything else
    to one overflow slot, ``E_loc * C``, which is discarded: several pairs
    may write it, in no fixed order on CUDA, and nothing reads it.  The sum
    over ranks is one all_reduce over the expert axis; the shared expert,
    TP-sharded like a dense MLP, has its own.

    The combine adds each token's K weighted contributions in slot order,
    one after another in x's dtype, as the reference's scatter-add rounds
    them: ``c_k = round(e_k * round(w_k * local_k))``, ``y = c_0``, then ``y =
    round(y + c_k)``, a dropped or remote pair's +0.0 added in its place.
    The order is fixed, so the result is the same on every run (an
    ``index_add_`` adds by atomics on CUDA, in an order that changes the
    bf16 rounding).

    ``impl="reference"`` (the verifier, training, decode) moves the rows
    with PyTorch expressions: a zero-filled buffer ``index_copy_``'d from
    ``xf[tok]``, then ``cat`` of the experts' output and the overflow row,
    ``flat[slot]`` times the weights and the K - 1 adds.  ``impl="kernel"``
    (prefill) builds a source map (``_source_map``) and moves the rows with
    the hand-written kernels ``ops.moe_gather`` and ``ops.moe_combine``, with
    no (pair, D) tensor.  There the fixed add order lives in the combine
    kernel (``kernels/csrc/moe_dispatch.cu``; on the CPU its plain version,
    ``kernels/moe_dispatch.py``), bit for bit the reference's."""
    B, S, D = x.shape
    T = B * S
    E = cfg.experts
    K = cfg.top_k
    C = moe_capacity(cfg, T)
    xf = x.reshape(T, D)
    with span("moe.router"):
        w, idx = _route(cfg, p, xf)

    with span("moe.positions"):
        # flatten (token, slot) pairs and compute per-expert positions
        eid = idx.reshape(T * K)
        # the one-hot laid out (E, TK), so each expert's cumsum runs along
        # the innermost dim: the (TK, E) layout's scan over the outer dim
        # took 3.2 of a 4.0 ms dispatch on an H100 (granite_moe_3b at (2,
        # 1024), the MoE slice's profile in PERF_HISTORY.md)
        onehot = (torch.arange(E, device=x.device)[:, None] == eid).to(torch.int32)
        pos = (torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot).sum(0) - 1  # (TK,)
        keep = pos < C

        # expert parallelism: this rank owns experts [first, first + E_loc)
        ep = ctx.ep_size if ctx.ep_axis else 1
        E_loc = E // ep
        first = ctx.ep_index() * E_loc
        mine = (eid >= first) & (eid < first + E_loc)
        local = mine & keep
        slot = torch.where(local, (eid - first) * C + pos, E_loc * C)  # overflow slot
        if _ROUTING is not None:
            _ROUTING.append({"idx": idx, "dropped": (mine & ~keep).sum()})

    with span("moe.gather"):
        if impl == "kernel":
            src = _source_map(slot, K, E_loc * C)
            ein = ops.moe_gather(xf, src[: E_loc * C]).reshape(E_loc, C, D)
        else:
            tok = torch.arange(T * K, device=x.device) // K
            buf = x.new_zeros((E_loc * C + 1, D)).index_copy_(0, slot, xf[tok])
            ein = buf[: E_loc * C].reshape(E_loc, C, D)

    with span("moe.experts"):
        h = F.silu(torch.bmm(ein, p["wg"])) * torch.bmm(ein, p["wu"])
        eout = torch.bmm(h, p["wo"])  # (E_loc, C, D)

    with span("moe.combine"):
        if impl == "kernel":  # partial over the expert axis
            y = ops.moe_combine(eout.reshape(E_loc * C, D), slot, w.to(x.dtype), local)
        else:
            wflat = w.reshape(T * K).to(x.dtype)
            flat = torch.cat([eout.reshape(E_loc * C, D), x.new_zeros((1, D))])
            contrib = (flat[slot] * (wflat * local.to(wflat.dtype))[:, None]).reshape(T, K, D)
            y = contrib[:, 0]
            for k in range(1, K):  # partial over the expert axis
                y = y + contrib[:, k]
        y = ctx.psum_ep(y).reshape(B, S, D)
        if "shared" in p:
            # the shared expert is column/row TP-sharded like a dense MLP:
            # its output is a partial sum and needs its own reduction (the
            # missing psum the verifier caught in the reference)
            y = y + ctx.psum_tp(_shared_fwd(cfg, p["shared"], x))
    if ctx.sp and ctx.tp_axis:
        # under SP the caller expects a sequence-sharded activation; y is
        # replicated here so the local shard is just a slice
        chunk = S // ctx.tp_size
        y = dynamic_slice_in_dim(y, ctx.tp_index() * chunk, chunk, axis=1)
    return y


def _dense_router_weights(cfg, p, xf):
    """Dense top-k routing mask (T, E) float32: softmax + top-k +
    renormalize, scattered back to a dense per-expert weight column."""
    T = xf.shape[0]
    w, idx = _route(cfg, p, xf)
    dense_w = torch.zeros((T, cfg.experts), dtype=torch.float32, device=xf.device)
    tok = torch.arange(T, device=xf.device)[:, None].repeat(1, cfg.top_k)
    return dense_w.index_put((tok.reshape(-1), idx.reshape(-1)), w.reshape(-1),
                             accumulate=True)


def moe_dense_fwd(cfg, ctx: ParallelCtx, p, x):
    """Dense-masked MoE formulation: every expert computes every token and a
    top-k weight mask combines them.  Numerically equals capacity-MoE with
    infinite capacity; cost O(E/topk) higher.  It is the *verification*
    graph (static dataflow: all ops are einsums over the expert dim, TP
    shards the expert FFN width, one psum discharges); the execution path
    stays the capacity dispatch (``moe_fwd``)."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    dense_w = _dense_router_weights(cfg, p, xf).to(x.dtype)

    h = F.silu(torch.einsum("td,edf->tef", xf, p["wg"])) * torch.einsum(
        "td,edf->tef", xf, p["wu"])
    eout = torch.einsum("tef,efd->ted", h, p["wo"])  # partial over sharded f
    y = torch.einsum("ted,te->td", eout, dense_w)
    y = ctx.psum_tp(y).reshape(B, S, D)
    if "shared" in p:
        y = y + ctx.psum_tp(_shared_fwd(cfg, p["shared"], x))
    if ctx.sp and ctx.tp_axis:
        # under SP the caller expects a sequence-sharded activation; y is
        # replicated here so the local shard is just this rank's slice
        chunk = S // ctx.tp_size
        y = dynamic_slice_in_dim(y, ctx.tp_index() * chunk, chunk, axis=1)
    return y


def moe_ep_fwd(cfg, ctx: ParallelCtx, p, x):
    """Expert-parallel dense-masked MoE (the EP *verification* formulation):
    each rank holds its expert slice of the stacked weights (``(E_loc, D,
    F)``, sharded over the expert dim), takes its slice of the dense routing
    mask by rank index, and accumulates the weighted local expert outputs
    as an **unrolled slice/add loop** discharged by one all_reduce over the
    expert axis: the paper's slice / loop_red_B / loop_red_D relation
    family (Fig. 8) on a whole model.  Numerically equals
    ``moe_dense_fwd``; with ``ParallelCtx.single()`` (ep=1) the same code is
    the dense baseline whose add-chain over all E expert slices is what
    ``loop_red_B`` matches."""
    B, S, D = x.shape
    T = B * S
    E = cfg.experts
    xf = x.reshape(T, D)
    dense_w = _dense_router_weights(cfg, p, xf).to(x.dtype)

    ep = ctx.ep_size if ctx.ep_axis else 1
    E_loc = E // ep
    if ctx.ep_axis:
        dw = dynamic_slice_in_dim(dense_w, ctx.ep_index() * E_loc, E_loc, axis=1)
    else:
        dw = dense_w  # (T, E): the full dense mask

    # local expert compute: (T, E_loc, D); weights arrive expert-sharded
    h = F.silu(torch.einsum("td,edf->tef", xf, p["wg"])) * torch.einsum(
        "td,edf->tef", xf, p["wu"])
    eout = torch.einsum("tef,efd->ted", h, p["wo"])
    weighted = eout * dw[:, :, None]  # (T, E_loc, D)

    # unrolled per-expert accumulation (slice -> add chain)
    acc = weighted[:, 0:1]
    for e in range(1, E_loc):
        acc = acc + weighted[:, e:e + 1]  # (T, 1, D)
    y = ctx.psum_ep(acc).reshape(B, S, D)
    if "shared" in p:
        # EP scenarios keep non-expert params replicated: the shared expert
        # runs dense (psum_tp is the identity without a tp axis)
        y = y + ctx.psum_tp(_shared_fwd(cfg, p["shared"], x))
    return y


def _shared_fwd(cfg, p, x):
    if cfg.mlp_act == "geglu":
        h = ACTS["gelu"](linear(p["wg"], x)) * linear(p["wu"], x)
    elif "wg" in p:
        h = F.silu(linear(p["wg"], x)) * linear(p["wu"], x)
    else:
        h = ACTS[cfg.mlp_act](linear(p["wi"], x))
    return linear(p["wo"], h)
