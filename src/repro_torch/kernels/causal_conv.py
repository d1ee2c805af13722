"""The Mamba-2 mixer's causal convs, biases and silu: the CUDA kernel's
wrapper and its plain version.

``causal_conv`` launches ``csrc/causal_conv.cu`` (built by ``build.py`` for
sm_90a, bound with ctypes) on the current stream.  It ports no Pallas
kernel: the JAX package leaves the conv to XLA.  It computes, for up to
three inputs at once (a mixer's x, B and C) in one launch, each input's
depthwise causal conv along the sequence, its optional bias and silu, so
that the execution path (``models/ssm.py`` ``ssm_fwd``, ``impl="kernel"``)
forms no padded copy and no per-tap intermediate.

``causal_conv_plain`` is that arithmetic in PyTorch, as the reference path
computes it: ``models/ssm.py``'s ``_causal_conv`` (the taps added one after
another in the input's dtype, from zeros, then the bias) followed by
``F.silu``.  The kernel rounds as that sequence of PyTorch calls does, so
the two agree bit for bit.

Every input's channels are moved as 16-byte vectors (8 bfloat16 or 4
float32 channels); a channel count the vectors cannot cut raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

MAX_TAPS = 8
MAX_INPUTS = 3
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def causal_conv_plain(*convs):
    """Each ``(x, w, b)`` of ``convs`` (x (B, S, C), w (K, C), b (C,) or
    None) -> ``silu(causal_conv(x, w) + b)`` (B, S, C), as a tuple."""
    from repro_torch.models.ssm import _causal_conv  # models/ imports this module

    return tuple(F.silu(_causal_conv(x, w, b)) for x, w, b in convs)


def _check(convs) -> None:
    """Raise unless the kernel takes ``convs``: one to three inputs of one
    dtype (float32 or bfloat16), batch, sequence, device and tap count
    (1 to 8), each contiguous, 16-byte aligned and as wide as its weights
    and bias, with a channel count the 16-byte vectors cut."""
    if not 1 <= len(convs) <= MAX_INPUTS:
        raise ValueError(f"1 to {MAX_INPUTS} inputs, got {len(convs)}")
    x0, w0 = convs[0][0], convs[0][1]
    if x0.dtype not in _DTYPES:
        raise ValueError(f"dtype {x0.dtype} not supported (float32, bfloat16)")
    per_vec = 16 // x0.element_size()
    for i, (x, w, b) in enumerate(convs):
        if x.dim() != 3 or w.dim() != 2 or (b is not None and b.dim() != 1):
            raise ValueError(f"input {i}: x must be (B, S, C), w (K, C), b (C,); got "
                             f"{tuple(x.shape)}, {tuple(w.shape)}, "
                             f"{None if b is None else tuple(b.shape)}")
        C = x.shape[2]
        if x.shape[:2] != x0.shape[:2] or w.shape != (w0.shape[0], C) or (
                b is not None and b.shape != (C,)):
            raise ValueError(f"input {i}: shapes {tuple(x.shape)}, {tuple(w.shape)} do not "
                             f"match the first input's {tuple(x0.shape)}, {tuple(w0.shape)}")
        if any(t.dtype != x0.dtype for t in (x, w, b) if t is not None):
            raise ValueError(f"input {i}: every tensor must be {x0.dtype}")
        if C % per_vec:
            raise ValueError(f"input {i}: {C} channels are not a multiple of {per_vec}: the "
                             f"kernel moves {x0.dtype} channels as 16-byte vectors")
    if not 1 <= w0.shape[0] <= MAX_TAPS:
        raise ValueError(f"{w0.shape[0]} taps not in [1, {MAX_TAPS}]")
    if min(x0.shape) == 0 or x0.shape[0] > 65535:
        raise ValueError(f"batch and sequence must be non-empty, the batch at most 65535; "
                         f"got {tuple(x0.shape)}")
    for x, w, b in convs:
        for t in (x, w, b):
            if t is None:
                continue
            build.require_hopper(t)
            if t.device != x0.device:
                raise ValueError("every input must lie on one device")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("every input must be contiguous and 16-byte aligned")


# (xs, ws, bs, outs, channels, n, dtype, B, S, K, stream)
KERNEL = build.Kernel("causal_conv", "repro_causal_conv_silu",
                      (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 2 + (ctypes.c_longlong,) * 2
                      + (ctypes.c_int,))


def causal_conv(*convs):
    """Launch the kernel on the inputs' device and current stream: one
    launch for every ``(x, w, b)`` of ``convs``."""
    _check(convs)
    n = len(convs)
    x0 = convs[0][0]
    ys = tuple(torch.empty_like(x) for x, _, _ in convs)
    ptrs = ctypes.c_void_p * n
    xs = ptrs(*(x.data_ptr() for x, _, _ in convs))
    ws = ptrs(*(w.data_ptr() for _, w, _ in convs))
    bs = ptrs(*(None if b is None else b.data_ptr() for _, _, b in convs))
    outs = ptrs(*(y.data_ptr() for y in ys))
    channels = (ctypes.c_longlong * n)(*(x.shape[2] for x, _, _ in convs))
    B, S, _ = x0.shape
    KERNEL(x0, xs, ws, bs, outs, channels, n, _DTYPES[x0.dtype], B, S, convs[0][1].shape[0])
    causal_conv.launches += 1
    return ys


causal_conv.launches = 0
