"""MoE capacity dispatch: the CUDA kernels' wrappers and their plain versions.

``moe_gather`` and ``moe_combine`` launch ``csrc/moe_dispatch.cu`` (built by
``build.py`` for sm_90a, bound with ctypes) on the current stream.  They
port no Pallas kernel: the JAX package dispatches with XLA's scatter and
gather.  They move the capacity dispatch's rows by index, so that the
execution path (``models/mlp.py`` ``moe_fwd``, ``impl="kernel"``) forms no
(pair, D) tensor:

- ``moe_gather(xf, src)``: buffer row r is ``xf[src[r]]``, or zeros where
  ``src[r] < 0``; the reference's zero-filled buffer after its
  ``index_copy_``, bit for bit.
- ``moe_combine(eout, slot, w, local)``: token t's output is the sum of its
  K pairs' ``eout[slot] * (w * local)``, each product rounded to the output's
  type, added one after another in slot order with a rounding after each
  add; a dropped or remote pair adds +0.0 in its place.  That is the
  reference's rounding sequence, so the result is its own, bit for bit.

The kernels' block and vector widths follow the row length and the dtype
(16-byte vectors, else 8 or 4); a row the vectors cannot cut raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_TOP_K = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def moe_gather_plain(xf, src):
    """xf: (T, D); src: (rows,) int32 -> (rows, D): row r is ``xf[src[r]]``,
    or zeros where ``src[r] < 0``."""
    return torch.where((src >= 0)[:, None], xf[src.clamp_min(0)], 0)


def moe_combine_plain(eout, slot, w, local):
    """eout: (rows, D); slot, local: (T*K,), int64 and bool; w: (T, K) in
    eout's dtype -> y (T, D): the K products ``e_k * (w_k * local_k)``, e_k
    zero for a pair that is not ``local``, added in slot order."""
    T, K = w.shape
    e = torch.where(local[:, None], eout[torch.where(local, slot, 0)], 0)
    contrib = (e * (w.reshape(T * K) * local.to(w.dtype))[:, None]).reshape(T, K, -1)
    y = contrib[:, 0]
    for k in range(1, K):
        y = y + contrib[:, k]
    return y


def _vec_bytes(row_bytes: int, *ts) -> int:
    """The widest vector (16, 8 or 4 bytes) that cuts a row and every
    pointer of ``ts``; raises where none does."""
    for vec in (16, 8, 4):
        if row_bytes % vec == 0 and all(t.data_ptr() % vec == 0 for t in ts):
            return vec
    raise ValueError(f"a row of {row_bytes} bytes (or an address) is not a multiple of "
                     f"4 bytes: the kernel moves rows as 4-, 8- or 16-byte vectors")


def _check(name, t, dim, dtype=None):
    build.require_hopper(t)
    if t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-d, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


# (xf, src, out, rows, T, row_bytes, vec, stream)
GATHER = build.Kernel("moe_dispatch", "repro_moe_gather",
                      (ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) * 3 + (ctypes.c_int,))
# (eout, slot, w, local, y, dtype, T, rows, K, D, vec, stream)
COMBINE = build.Kernel("moe_dispatch", "repro_moe_combine", (ctypes.c_void_p,) * 5
                       + (ctypes.c_int,) + (ctypes.c_longlong,) * 2 + (ctypes.c_int,) * 3)


def moe_gather(xf, src):
    """Launch the gather on xf's device and current stream."""
    _check("xf", xf, 2)
    _check("src", src, 1, torch.int32)
    if xf.dtype not in _DTYPES or src.device != xf.device:
        raise ValueError(f"xf must be float32 or bfloat16 and share src's device, got "
                         f"{xf.dtype} on {xf.device}, src on {src.device}")
    T, D = xf.shape
    out = torch.empty((src.shape[0], D), dtype=xf.dtype, device=xf.device)
    row_bytes = D * xf.element_size()
    vec = _vec_bytes(row_bytes, xf, out)
    GATHER(xf, xf.data_ptr(), src.data_ptr(), out.data_ptr(), src.shape[0], T, row_bytes, vec)
    moe_gather.launches += 1
    return out


moe_gather.launches = 0


def moe_combine(eout, slot, w, local):
    """Launch the combine on eout's device and current stream."""
    _check("eout", eout, 2)
    _check("w", w, 2, eout.dtype)
    _check("slot", slot, 1, torch.int64)
    _check("local", local, 1, torch.bool)
    if eout.dtype not in _DTYPES:
        raise ValueError(f"dtype {eout.dtype} not supported (float32, bfloat16)")
    T, K = w.shape
    if not 0 < K <= MAX_TOP_K:
        raise ValueError(f"top-k {K} not in (0, {MAX_TOP_K}]")
    if slot.shape[0] != T * K or local.shape[0] != T * K:
        raise ValueError(f"slot and local must hold {T} x {K} pairs, got "
                         f"{tuple(slot.shape)}, {tuple(local.shape)}")
    if len({t.device for t in (eout, slot, w, local)}) != 1:
        raise ValueError("eout, slot, w and local must share one device")
    rows, D = eout.shape
    y = torch.empty((T, D), dtype=eout.dtype, device=eout.device)
    vec = _vec_bytes(D * eout.element_size(), eout, y)
    COMBINE(eout, eout.data_ptr(), slot.data_ptr(), w.data_ptr(), local.data_ptr(),
            y.data_ptr(), _DTYPES[eout.dtype], T, rows, K, D, vec)
    moe_combine.launches += 1
    return y


moe_combine.launches = 0
