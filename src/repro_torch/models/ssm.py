"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

Port of the JAX package's ``models/ssm.py``.  ``ssd_chunked`` is the
semantic reference, the chunked SSD algorithm in plain torch:

  within chunk:  Y_diag = (C B^T ⊙ L) · (dt x)        (attention-like products)
  chunk states:  S_c    = Σ_k decay_to_end · dt_k B_k x_k^T
  across chunks: S_c   <- S_{c-1} · Π decay + S_c      (short loop over chunks)
  offset:        Y_off  = decay_from_start · C S_{c-1}

``ssm_fwd(impl="kernel")`` runs the SSD scan kernel instead, the three
causal convs with their biases and silu as one kernel, and the D skip, the
cast and the gated norm after the scan as another
(``repro_torch.kernels.ops``).  Decode keeps O(1) state per head and
bypasses the kernel, as in the JAX package.

Two options of the port's own (the JAX package has neither): a bias on each
causal conv (``cfg.ssm_conv_bias``, the ``conv_bias`` leaves) and the gated
norm's group (``cfg.ssm_norm_group``; 0 keeps one group per SSD head).
Inside ``scope.spans()`` the full-sequence block opens ``ssm.proj``,
``ssm.conv``, ``ssm.scan``, ``ssm.norm`` (the D skip, the cast and the
gated norm) and ``ssm.out``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import chunk_len
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.scope import loop, named_scope, span

from .modules import _init, gated_rmsnorm, linear, linear_init, rmsnorm_init, silu


def ssm_init(generator, cfg, *, stacked: tuple = (), dtype=torch.bfloat16):
    D, N = cfg.d_model, cfg.ssm_state
    DI = cfg.d_inner_p  # padded inner width (TP divisibility)
    H = cfg.ssm_heads_p
    dev = generator.device
    p = {
        "wx": linear_init(generator, D, DI, dtype=dtype, stacked=stacked),
        "wz": linear_init(generator, D, DI, dtype=dtype, stacked=stacked),
        "wB": linear_init(generator, D, N, dtype=dtype, stacked=stacked),
        "wC": linear_init(generator, D, N, dtype=dtype, stacked=stacked),
        "wdt": linear_init(generator, D, H, dtype=dtype, stacked=stacked),
        "dt_bias": torch.zeros((*stacked, H), dtype=torch.float32, device=dev),
        "A_log": _init(generator, (*stacked, H), 1.0, torch.float32),
        "Dskip": torch.ones((*stacked, H), dtype=torch.float32, device=dev),
        "conv_x": _init(generator, (*stacked, cfg.ssm_conv, DI), 1.0, dtype),
        "conv_B": _init(generator, (*stacked, cfg.ssm_conv, N), 1.0, dtype),
        "conv_C": _init(generator, (*stacked, cfg.ssm_conv, N), 1.0, dtype),
        "out_norm": rmsnorm_init(generator, DI, dtype, stacked),
        "wo": linear_init(generator, DI, D, dtype=dtype, stacked=stacked),
    }
    if cfg.ssm_conv_bias:
        p["conv_bias"] = {c: {"b": torch.zeros((*stacked, n), dtype=dtype, device=dev)}
                          for c, n in (("x", DI), ("B", N), ("C", N))}
    return p


def _conv_bias(cfg, p, which: str):
    """The bias of conv ``which`` (``"x"``, ``"B"`` or ``"C"``), or None."""
    return p["conv_bias"][which]["b"] if cfg.ssm_conv_bias else None


def _norm_group(cfg, width: int) -> int:
    """The gated norm's group: ``cfg.ssm_norm_group``, or one SSD head.  It
    must divide this rank's inner width (a group cut across TP ranks would
    need a reduction the block does not make)."""
    group = cfg.ssm_norm_group or cfg.ssm_head_dim
    if width % group:
        raise ValueError(f"the gated norm's group of {group} channels does not divide "
                         f"the local inner width {width}")
    return group


def _causal_conv(x, w, b=None):
    """Depthwise causal conv along seq: x (B,S,C), w (K,C), an optional bias
    b (C,).  Adds tap by tap in x's dtype, as the JAX version does
    (``F.conv1d`` would accumulate in f32, and through cuDNN in TF32), then
    the bias."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + S, :] * w[k]
    return out if b is None else out + b


def _segsum(dA):
    """Cumulative within-chunk log-decay differences.
    dA: (..., Q) -> (..., Q, Q) lower-triangular sums dA[j+1..i]."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum over (j, i]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None, return_state: bool = False,
                unroll: bool = False):
    """SSD scan.  x: (B,S,H,P), dt: (B,S,H) (post-softplus), A: (H,) negative,
    Bm/Cm: (B,S,N).  Returns y: (B,S,H,P) [, final_state (B,H,P,N)].
    ``unroll`` is accepted for the JAX signature; the chunk loop is always
    Python."""
    del unroll
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk_len(S, chunk)
    nc = S // Q
    f32 = torch.float32

    with named_scope("ssd_kernel"):  # the region K3 computes on the kernel path
        xc = x.reshape(Bsz, nc, Q, H, P)
        dtc = dt.reshape(Bsz, nc, Q, H).float()
        Bc = Bm.reshape(Bsz, nc, Q, N)  # converted at each use, as in JAX
        Cc = Cm.reshape(Bsz, nc, Q, N)
        dA = dtc * A  # (B,nc,Q,H) log-decay per step

        # within-chunk ("diagonal") term
        L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (B,nc,H,Q,Q)
        scores = torch.einsum("bcqn,bckn->bcqk", Cc.float(), Bc.float())
        att = scores[:, :, None, :, :] * L  # (B,nc,H,Q,K); L zero above diagonal
        xdt = xc.float() * dtc[..., None]  # (B,nc,Q,H,P)
        y_diag = torch.einsum("bchqk,bckhp->bcqhp", att, xdt)

        # per-chunk states
        cum = torch.cumsum(dA, dim=2)  # (B,nc,Q,H)
        decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,Q,H)
        states = torch.einsum("bckn,bckh,bckhp->bchpn", Bc.float(), decay_end * dtc, xc.float())

        # inter-chunk recurrence
        chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H)
        s = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device) if init_state is None
             else init_state.float())
        prevs = []
        for ci in loop(nc, "ssd_chunk"):
            prevs.append(s)
            s = s * chunk_decay[:, ci, :, None, None] + states[:, ci]
        # (B,nc,H,P,N) entering each chunk (in count mode one chunk ran: the
        # state it leaves stands for the later chunks')
        prev = torch.stack(prevs + [s] * (nc - len(prevs))).permute(1, 0, 2, 3, 4)

        decay_start = torch.exp(cum)  # (B,nc,Q,H)
        y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc.float(), prev, decay_start)

        y = (y_diag + y_off).reshape(Bsz, S, H, P)
        if return_state:
            return y, s
        return y


def skip_gated_norm_plain(y, xh, D, z, s, *, eps: float, group: int):
    """The mixer after the scan: the D skip over the scan's f32 y (B, S, H,
    P), the cast to xh's dtype, then the gated norm by silu(z) (B, S, H * P)
    over groups of ``group`` channels, times the scale s (H * P,).  The plain
    version of ``kernels/csrc/skip_gated_norm.cu``, which ``ssm_fwd`` runs
    on the reference path and on the CPU."""
    B, S, H, P = y.shape
    y = (y + D[..., None] * xh.float()).reshape(B, S, H * P).to(xh.dtype)
    return gated_rmsnorm({"s": s}, y, z, eps, group=group)


def ssm_fwd(cfg, ctx: ParallelCtx, p, x, *, impl: str = "reference",
            unroll: bool = False):
    """Full-sequence SSD block.  x: (B, S, D) replicated."""
    B, S, D = x.shape
    P = cfg.ssm_head_dim
    with span("ssm.proj"):
        xproj = linear(p["wx"], x)  # (B,S,DI_loc) column-parallel over heads
        z = linear(p["wz"], x)
        Bm = linear(p["wB"], x)  # replicated (single SSD group)
        Cm = linear(p["wC"], x)
        dt_raw = linear(p["wdt"], x).float()  # (B,S,H_loc)

    with span("ssm.conv"):
        convs = [(t, p[f"conv_{c}"], _conv_bias(cfg, p, c))
                 for t, c in ((xproj, "x"), (Bm, "B"), (Cm, "C"))]
        if impl == "kernel":
            xproj, Bm, Cm = kops.causal_conv(*convs)
        else:
            xproj, Bm, Cm = (F.silu(_causal_conv(*conv)) for conv in convs)

    with span("ssm.scan"):
        H_loc = xproj.shape[-1] // P
        # dt is head-wise; under TP wdt is column-sharded to the local heads
        dt = F.softplus(dt_raw + p["dt_bias"][..., :H_loc])
        A = -torch.exp(p["A_log"][..., :H_loc].float())
        xh = xproj.reshape(B, S, H_loc, P)
        if impl == "kernel":
            y = kops.ssd_scan(xh.contiguous(), dt.contiguous(), A.contiguous(),
                              Bm.contiguous(), Cm.contiguous(), chunk=cfg.ssm_chunk)
        else:
            y = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, unroll=unroll)
    with span("ssm.norm"):
        args = (y, xh, p["Dskip"][..., :H_loc], z, p["out_norm"]["s"])
        kw = {"eps": cfg.norm_eps, "group": _norm_group(cfg, H_loc * P)}
        if impl == "kernel" and y.device.type != "cpu":
            y = kops.skip_gated_norm(*args, **kw)
        else:
            y = skip_gated_norm_plain(*args, **kw)
    with span("ssm.out"):
        out = linear(p["wo"], y)  # row-parallel
    return ctx.sp_enter(out)


def ssm_init_cache(cfg, batch: int, tp_size: int = 1, dtype=torch.bfloat16,
                   device="cpu"):
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    H_loc = cfg.ssm_heads_p // tp_size
    DI_loc = H_loc * P
    K = cfg.ssm_conv
    return {
        "state": torch.zeros((batch, H_loc, P, N), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, K - 1, DI_loc), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, K - 1, N), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, K - 1, N), dtype=dtype, device=device),
    }


def ssm_decode(cfg, ctx: ParallelCtx, p, x, cache):
    """Single-token SSD step: O(1) state update.  x: (B, 1, D).  Returns the
    output and new cache tensors (``cache`` itself is not written)."""
    B = x.shape[0]
    P = cfg.ssm_head_dim
    xproj = linear(p["wx"], x)[:, 0]  # (B, DI_loc)
    z = linear(p["wz"], x)[:, 0]
    Bm = linear(p["wB"], x)[:, 0]
    Cm = linear(p["wC"], x)[:, 0]
    dt_raw = linear(p["wdt"], x)[:, 0].float()

    def conv_step(buf, new, w, b):
        # buf: (B, K-1, C) previous inputs; new: (B, C)
        full = torch.cat([buf, new[:, None]], dim=1)  # (B,K,C)
        out = torch.einsum("bkc,kc->bc", full, w)
        return out if b is None else out + b, full[:, 1:]

    cx, ncx = conv_step(cache["conv_x"], xproj, p["conv_x"], _conv_bias(cfg, p, "x"))
    cB, ncB = conv_step(cache["conv_B"], Bm, p["conv_B"], _conv_bias(cfg, p, "B"))
    cC, ncC = conv_step(cache["conv_C"], Cm, p["conv_C"], _conv_bias(cfg, p, "C"))
    cx = silu(cx)
    cB = silu(cB).float()
    cC = silu(cC).float()

    H_loc = cx.shape[-1] // P
    dt = F.softplus(dt_raw + p["dt_bias"][..., :H_loc])  # (B,H)
    A = -torch.exp(p["A_log"][..., :H_loc].float())
    xh = cx.reshape(B, H_loc, P).float()
    decay = torch.exp(dt * A)  # (B,H)
    h = cache["state"] * decay[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, cB, xh)
    y = torch.einsum("bn,bhpn->bhp", cC, h) + p["Dskip"][..., :H_loc, None] * xh
    y = y.reshape(B, 1, H_loc * P).to(x.dtype)
    y = gated_rmsnorm(p["out_norm"], y, z[:, None], cfg.norm_eps,
                      group=_norm_group(cfg, H_loc * P))
    out = linear(p["wo"], y)
    return ctx.sp_enter(out), {
        "state": h,
        "conv_x": ncx,
        "conv_B": ncB,
        "conv_C": ncC,
    }
