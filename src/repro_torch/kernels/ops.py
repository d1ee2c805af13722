"""Public wrappers for the hand-written kernels.

A tensor on the CPU takes the kernel's plain PyTorch version.  A CUDA tensor
on a capability-(9, 0) device launches the kernel; on any other device the
kernel's wrapper raises.  ``skip_gated_norm`` alone launches only: its plain
version is the Mamba-2 mixer's own lines (``models/ssm.py``
``skip_gated_norm_plain``), which ``ssm_fwd`` runs on the CPU itself, as
this layer imports nothing from ``models/``.  A failed build or launch raises; nothing falls
back.

The kernels have no backward, as the Pallas kernels they port have none: a
CUDA kernel writes into a fresh tensor outside autograd, so a gradient
through it would be cut without a word.  Every wrapper therefore refuses an
input that autograd tracks (``requires_grad`` under grad mode, or a
``torch.func`` grad transform's tensor), on both devices, so that the CPU
tests catch what the card would do.  Training runs ``impl="reference"``.
"""
from __future__ import annotations

import torch
from torch._C import _functorch

from . import causal_conv as _cc
from . import flash_attention as _fa
from . import moe_dispatch as _moe
from . import rmsnorm as _rn
from . import skip_gated_norm as _sgn
from . import ssd_scan as _ssd


def _refuse_autograd(name: str, *tensors) -> None:
    if not torch.is_grad_enabled():
        return
    if any(t.requires_grad or _functorch.is_gradtrackingtensor(t) for t in tensors):
        raise RuntimeError(
            f"the {name} kernel has no backward: it would cut the autograd graph; "
            f"train with Model(impl='reference'), or call it under torch.no_grad()")


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D); ``scale``
    multiplies the scores (None: 1 / sqrt(D))."""
    _refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale)


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: (..., D); scale: (D,)."""
    _refuse_autograd("rmsnorm", x, scale)
    if x.device.type == "cpu":
        return _rn.rmsnorm_plain(x, scale, eps=eps)
    return _rn.rmsnorm(x, scale, eps=eps)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N) -> y (B,S,H,P) f32."""
    _refuse_autograd("ssd_scan", x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)


def moe_gather(xf, src):
    """xf: (T, D); src: (rows,) int32, a token or -1 -> (rows, D)."""
    _refuse_autograd("moe_gather", xf)
    if xf.device.type == "cpu":
        return _moe.moe_gather_plain(xf, src)
    return _moe.moe_gather(xf, src)


def moe_combine(eout, slot, w, local):
    """eout: (rows, D); slot, local: (T*K,) int64, bool; w: (T, K) -> (T, D)."""
    _refuse_autograd("moe_combine", eout, w)
    if eout.device.type == "cpu":
        return _moe.moe_combine_plain(eout, slot, w, local)
    return _moe.moe_combine(eout, slot, w, local)


def causal_conv(*convs):
    """Each ``(x, w, b)`` of ``convs``: x (B, S, C), w (K, C), b (C,) or None
    -> ``silu(causal_conv(x, w) + b)`` (B, S, C); a tuple, one launch."""
    _refuse_autograd("causal_conv", *(t for conv in convs for t in conv if t is not None))
    if convs[0][0].device.type == "cpu":
        return _cc.causal_conv_plain(*convs)
    return _cc.causal_conv(*convs)


def skip_gated_norm(y, x, D, z, s, *, eps: float, group: int):
    """y: (B, S, H, P) f32, K3's output; x: (B, S, H, P); D: (H,) f32; z: (B,
    S, H * P); s: (H * P,) -> the gated norm of ``(y + D * x).to(x.dtype)``
    over groups of ``group`` channels, (B, S, H * P) in x's dtype; on the
    card only (the plain version: ``models/ssm.py`` ``skip_gated_norm_plain``)."""
    _refuse_autograd("skip_gated_norm", y, x, D, z, s)
    return _sgn.skip_gated_norm(y, x, D, z, s, eps=eps, group=group)
