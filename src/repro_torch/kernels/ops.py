"""Public wrappers for the hand-written kernels.

A tensor on the CPU takes the kernel's plain PyTorch version.  A CUDA tensor
on a capability-(9, 0) device launches the kernel; on any other device the
kernel's wrapper raises.  A failed build or launch raises; nothing falls
back.
"""
from __future__ import annotations

from . import flash_attention as _fa
from . import rmsnorm as _rn
from . import ssd_scan as _ssd


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D)."""
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal)
    return _fa.flash_attention(q, k, v, causal=causal)


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: (..., D); scale: (D,)."""
    if x.device.type == "cpu":
        return _rn.rmsnorm_plain(x, scale, eps=eps)
    return _rn.rmsnorm(x, scale, eps=eps)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N) -> y (B,S,H,P) f32."""
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
