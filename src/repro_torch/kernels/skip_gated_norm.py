"""The Mamba-2 mixer's epilogue (the D skip, the cast and the gated norm):
the CUDA kernel's checks and launch.

``skip_gated_norm`` launches ``csrc/skip_gated_norm.cu`` (built by
``build.py`` for sm_90a, bound with ctypes) on the current stream.  It ports
no Pallas kernel: the JAX package leaves the skip and the norm to XLA.  It
computes, in one pass over the SSD scan's f32 output y, what
``models/ssm.py`` ``skip_gated_norm_plain`` computes in PyTorch after the
scan (its plain version, which ``ssm_fwd`` runs on the CPU and on the
reference path):

    u = (y + D * x.float()).reshape(B, S, H * P).to(x.dtype)
    out = gated_rmsnorm({"s": s}, u, z, eps, group=group)

The kernel rounds where those lines round; only the order of each group's
sum of squares may differ, so its output equals the plain version's bit for
bit wherever a group's sum comes out the same.  ``rstd=True`` returns each
group's ``1 / sqrt(var + eps)`` beside the output, so that a check can hold
the rest to that.

A group is ``group`` channels (0, or the width or more: the whole row): 4 x
2^k channels up to 128, or a multiple of 128.  The width and the head size
are multiples of 4 channels; the width at most 16,384 (jamba_1_5_large's
mixer, the widest).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_WIDTH = 16384
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def group_of(width: int, group: int) -> int:
    """The channels a group spans: ``group``, or the whole row for 0 or a
    group at least as wide (as ``gated_rmsnorm`` reads it)."""
    return group if 0 < group < width else width


def _check(y, x, D, z, s, group: int) -> None:
    """Raise unless the kernel takes these tensors: y (B, S, H, P) float32;
    x of y's shape, z (B, S, H * P) and s (H * P,) in one dtype (float32 or
    bfloat16); D (H,) float32; a group that divides the width and that the
    kernel's reductions cut; contiguous tensors on one Hopper device."""
    if y.dim() != 4:
        raise ValueError(f"y must be (B, S, H, P), got {tuple(y.shape)}")
    B, S, H, P = y.shape
    W = H * P
    if (x.shape != y.shape or z.shape != (B, S, W) or D.shape != (H,)
            or s.shape != (W,)):
        raise ValueError(f"shapes do not match: y {tuple(y.shape)}, x {tuple(x.shape)}, "
                         f"D {tuple(D.shape)}, z {tuple(z.shape)}, s {tuple(s.shape)}")
    if x.dtype not in _DTYPES or z.dtype != x.dtype or s.dtype != x.dtype:
        raise ValueError(f"x, z and s must share a dtype of float32 or bfloat16, got "
                         f"{x.dtype}, {z.dtype}, {s.dtype}")
    if y.dtype != torch.float32 or D.dtype != torch.float32:
        raise ValueError(f"y and D must be float32, got {y.dtype}, {D.dtype}")
    g = group_of(W, group)
    if group < 0 or W % g:
        raise ValueError(f"a group of {group} channels does not divide the width {W}")
    if P % 4 or g % 4 or (g > 128 and g % 128) or (g <= 128 and 128 % g) or W > MAX_WIDTH:
        raise ValueError(f"the kernel takes head sizes and groups of 4 x 2^k channels up to "
                         f"128 or multiples of 128, widths up to {MAX_WIDTH}; got head "
                         f"size {P}, group {g}, width {W}")
    if B * S == 0:
        raise ValueError(f"no rows: {tuple(y.shape)}")
    for t in (y, x, D, z, s):
        build.require_hopper(t)
        if t.device != y.device:
            raise ValueError("every input must lie on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("every input must be contiguous and 16-byte aligned")


# (y, x, D, z, s, out, rstd, rows, width, head_dim, group, eps, dtype, stream)
KERNEL = build.Kernel("skip_gated_norm", "repro_skip_gated_norm",
                      (ctypes.c_void_p,) * 7 + (ctypes.c_longlong,) + (ctypes.c_int,) * 3
                      + (ctypes.c_float, ctypes.c_int))


def skip_gated_norm(y, x, D, z, s, *, eps: float, group: int, rstd: bool = False):
    """Launch the kernel on y's device and current stream; with ``rstd``,
    return ``(out, rstd)``, rstd (B, S, groups) float32."""
    _check(y, x, D, z, s, group)
    B, S, H, P = y.shape
    W = H * P
    g = group_of(W, group)
    out = torch.empty((B, S, W), dtype=x.dtype, device=x.device)
    r = torch.empty((B, S, W // g), dtype=torch.float32, device=x.device) if rstd else None
    KERNEL(y, y.data_ptr(), x.data_ptr(), D.data_ptr(), z.data_ptr(), s.data_ptr(),
           out.data_ptr(), None if r is None else r.data_ptr(), B * S, W, P, g, eps,
           _DTYPES[x.dtype])
    skip_gated_norm.launches += 1
    return (out, r) if rstd else out


skip_gated_norm.launches = 0
