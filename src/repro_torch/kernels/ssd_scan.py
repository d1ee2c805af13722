"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

``ssd_scan`` launches ``csrc/ssd_scan.cu`` (built by ``build.py`` for
sm_90a, bound with ctypes) on the current stream.  It is the port of the
Pallas kernel ``repro/kernels/ssd_scan.py``: each (b, h) walks its chunks in
order and carries an f32 (N, P) state from chunk to chunk; y is f32.  For
bf16 inputs a first launch forms C B^T once per (b, chunk) into a workspace
that the wrapper allocates, and the scan splits P across blocks.

``ssd_scan_plain`` does the Pallas kernel's per-chunk arithmetic in plain
PyTorch, in f32, chunk after chunk, batched over (b, h):
``cum = cumsum(dt * a)``, ``L = where(tri, exp(cum_i - cum_j), 0)``,
``y = (C B^T * L * dt_j) x + exp(cum) * (C state)`` and
``state' = state * exp(cum_Q) + (B * exp(cum_Q - cum) dt)^T x``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128)
MAX_STATE = 128
MAX_CHUNK = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chunk_len(S: int, chunk: int) -> int:
    """The chunk length ``q = min(chunk, S)``; raises ValueError unless S is a
    multiple of it."""
    q = min(chunk, S)
    if q < 1 or S % q:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {q}")
    return q


def ssd_scan_plain(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N) -> y (B,S,H,P) f32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    q = chunk_len(S, chunk)
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    a = A.float()
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // q):
        sl = slice(c * q, (c + 1) * q)
        xc, dtc, bc, cc = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(dtc * a, dim=1)  # (B,q,H)
        L = torch.where(tri, torch.exp(cum[:, :, None] - cum[:, None]), 0.0)  # (B,i,j,H)
        scores = torch.einsum("bin,bjn->bij", cc, bc)
        y_diag = torch.einsum("bijh,bjhp->bihp", scores[..., None] * L * dtc[:, None], xc)
        y_off = torch.exp(cum)[..., None] * torch.einsum("bin,bhnp->bihp", cc, state)
        ys.append(y_diag + y_off)
        decay_end = torch.exp(cum[:, -1:] - cum) * dtc  # (B,q,H)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "bjhn,bjhp->bhnp", bc[:, :, None, :] * decay_end[..., None], xc)
    return torch.cat(ys, dim=1)


def _check(x, dt, A, Bm, Cm, chunk: int) -> int:
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        build.require_hopper(t)
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError("all inputs must lie on one device")
    if x.dim() != 4:
        raise ValueError(f"x must be 4-d (B, S, H, P), got {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (Bsz, S, N) or tuple(Cm.shape) != (Bsz, S, N)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError("x, Bm and Cm must all be float32 or all bfloat16, got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P} not supported, one of {HEAD_DIMS}")
    if N % 8 or not 8 <= N <= MAX_STATE:
        raise ValueError(f"state width {N} must be a multiple of 8 in [8, {MAX_STATE}]")
    if min(Bsz, S, H) == 0:
        raise ValueError("empty input")
    if Bsz > 65535 or H > 65535:
        raise ValueError("B and H must be at most 65535")
    q = chunk_len(S, chunk)
    if q > MAX_CHUNK:
        raise ValueError(f"chunk {q} is longer than {MAX_CHUNK}")
    return q


# (x, dt, A, Bm, Cm, y, workspace, dtype, B, S, H, P, N, chunk, stream)
KERNEL = build.Kernel("ssd_scan", "repro_ssd_scan_fwd",
                      (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 7)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Launch the CUDA kernel on x's device and current stream."""
    q = _check(x, dt, A, Bm, Cm, chunk)
    Bsz, S, H, P = x.shape
    dtype = _DTYPES[x.dtype]
    # repro_ssd_scan_workspace_bytes(dtype, B, S, chunk)
    ws_bytes = build.bind("ssd_scan", "repro_ssd_scan_workspace_bytes", ctypes.c_longlong,
                          (ctypes.c_int,) * 4)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    ws = torch.empty(ws_bytes(dtype, Bsz, S, q), dtype=torch.uint8, device=x.device)
    KERNEL(x, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
           y.data_ptr(), ws.data_ptr() or None, dtype, Bsz, S, H, P, Bm.shape[-1], q)
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
