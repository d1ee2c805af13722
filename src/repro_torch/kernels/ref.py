"""Pure-torch oracles for the ported kernels.

Ports of the JAX package's ``kernels/ref.py`` definitions (naive softmax
attention, the literal SSD recurrence, RMSNorm), held to them on the CPU by
the tests.  Like the JAX oracle, ``attention_ref`` aligns the causal mask
bottom-right (``tril(k=Sk-Sq)``); the kernels align it top-left, so the two
agree only for ``Sq == Sk`` or ``causal=False``.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True):
    """Naive softmax attention.  q: (B,Hq,Sq,D); k/v: (B,Hkv,Sk,D)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kq = k.repeat_interleave(G, dim=1)
    vq = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq.float())
    s = s / math.sqrt(D)
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq.float()).to(q.dtype)


def ssd_ref(x, dt, A, Bm, Cm):
    """Literal SSD recurrence (sequential over time).

    x: (B,S,H,P); dt: (B,S,H) post-softplus; A: (H,) negative;
    Bm/Cm: (B,S,N).  y_t = C_t · h_t with h_t = exp(dt_t A) h_{t-1}
    + dt_t B_t x_t^T.   Returns y (B,S,H,P) float32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A)  # (B,H)
        h = h * decay[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dtf[:, t], Bf[:, t], xf[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1)  # (B,S,H,P)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale
