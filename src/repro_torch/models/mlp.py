"""Feed-forward blocks: dense GLU/GELU MLPs.  (MoE is not ported yet.)"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.ctx import ParallelCtx

from .modules import ACTS, linear, linear_init, silu


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
