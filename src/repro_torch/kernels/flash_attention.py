"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

``flash_attention`` launches ``csrc/flash_attention.cu`` (built by
``build.py`` for sm_90a, bound with ctypes) on the current stream.  It is
the port of the Pallas kernel ``repro/kernels/flash_attention.py``:
GQA/MQA/MHA, online softmax in f32, causal mask aligned top-left
(``q_pos >= k_pos`` from 0), ragged sequence edges masked in the kernel.
Head dims ``HEAD_DIMS``; D=80 runs on D=128's tiles, the columns past 80
filled with zeros by the kernel's loads (q, k and v are not padded here).

Both take the softmax scale of the scores as ``scale`` (``None``: 1 /
sqrt(D)).  ``flash_attention_plain`` computes the same function in plain
PyTorch: one softmax block over all keys, the same top-left mask, ``p`` rounded to v's
dtype before the PV product and divided by the f32 denominator afterwards.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

HEAD_DIMS = (32, 64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def softmax_scale(D: int, scale: float | None) -> float:
    """``scale``, or 1 / sqrt(D) where it is None."""
    return 1.0 / math.sqrt(D) if scale is None else float(scale)


def flash_attention_plain(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q's dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * softmax_scale(D, scale)
    if causal:
        pos_q = torch.arange(Sq, device=q.device)
        pos_k = torch.arange(Sk, device=q.device)
        s = s.masked_fill(pos_q[:, None] < pos_k[None, :], -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    out = acc / denom.clamp_min(1e-30)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require_hopper(t)
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d (B, H, S, D), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share one dtype and one device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported, one of {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if min(B, Sq, Sk) == 0:
        raise ValueError("empty input")
    if B > 65535 or Hq > 65535:
        raise ValueError("B and Hq must be at most 65535")


# (q, k, v, o, dtype, B, Hq, Hkv, Sq, Sk, D, causal, scale, stream)
KERNEL = build.Kernel("flash_attention", "repro_flash_attention_fwd_scaled",
                      (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (ctypes.c_double,))


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Launch the CUDA kernel on q's device and current stream."""
    _check(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    KERNEL(q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], B,
           Hq, Hkv, Sq, Sk, D, int(causal), softmax_scale(D, scale))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
