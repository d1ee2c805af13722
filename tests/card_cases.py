"""Each hand-written kernel's cases on the card and its tolerance, defined once.

``tests/test_torch_card_kernels.py`` (marked ``card``) holds every kernel to
its plain version over every row of its table; ``chip_smoke.py`` times the
rows that name a main path (``path``), each held to its plain version with
the same tolerance.  Each row's inputs are drawn here, from a generator on
the card.  Imports no JAX, no ``repro`` and no pytest.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import namedtuple

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import skip_gated_norm as sgn
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import mlp, ssm
from repro_torch.parallel.ctx import ParallelCtx

# Flash attention, (allclose rtol = atol, relative RMS error).  A causal row
# over n keys of N(0, 1) values has outputs of std about sqrt(e / n), about
# 0.07 at n = 512, so a bf16 limit near that size would pass a dropped or
# mis-masked KV tile (0.01-0.03 on the rows it touches).  1e-2 still admits
# one bf16 ulp on outputs of 1-4 (rows with few keys); an H100 measured
# 0.0039 max abs at the main shape.
FA_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (2e-4, 1e-4)}
# RMSNorm, in the same form: the kernel rounds where the plain version does;
# an f32 rsqrt that differs in its last bit can move a bf16 result by one ulp
# (2^-8 relative).
RN_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-5)}
# SSD scan, (allclose rtol = atol, relative RMS error).  Kernel and plain
# version compute in f32 from the same inputs (bf16 widened exactly) in
# another summation order: on an H100 the largest error, 3.0e-4 at the main
# shape, was under a third of the allclose limit there, and relative RMS
# errors were at most 2.3e-6 (PERF.md).  A kernel that drops or mis-decays the state
# carried between chunks moves the slow-decay cases by tens of percent
# (``ssd_restarted``).
SSD_TOL = (1e-3, 1e-5)
# The fused conv and the dispatch kernels round as their plain versions do:
# they are held to them bit for bit.
# The Mamba-2 mixer's skip and gated norm (kernels/skip_gated_norm.py) rounds
# as its plain version does except in the order of each group's sum of
# squares.  It is held to the plain arithmetic bit for bit given its own
# 1 / sqrt(var + eps) of each group (``sgn_given_rstd``), to the plain
# version bit for bit in every group whose rstd agrees, and elsewhere within
# limits set between two readings over every SGN_CASES row on an H100: the
# kernel's (K) and the plain version's with its variance rounded to bf16, a
# bf16 sum of squares (L):
# - rstd within SGN_RSTD_TOL, relative: K 2.1e-7 (two f32 ulps), L 1.8e-3;
# - the output within SGN_ULPS ulps of the model dtype: K 2 in bf16 (on
#   both main paths' rows: an rstd two f32 ulps off can move round(g * r)
#   across a rounding boundary, and the product with the scale carries that
#   to a second ulp), 4 in f32.  In bf16 L reads 2 ulps as well, so the
#   largest error cannot tell a bf16 variance apart; the RMS error can:
# - SGN_TOL as ``close`` takes it (allclose at rtol = atol, relative RMS
#   error): RMS K 1.2e-5 bf16, 4.6e-8 f32; L 2.1e-3 bf16, 8.0e-4 f32.  The
#   allclose part follows from the ulps in bf16 (2 ulps <= 2^-6 relative);
#   in f32 K reads 2.6e-7, L 1.5e-3.
SGN_TOL = {torch.bfloat16: (2**-6, 1e-4), torch.float32: (2**-16, 1e-6)}
SGN_ULPS = {torch.bfloat16: 2, torch.float32: 16}
SGN_RSTD_TOL = 2**-20
SGN_EPS = 1e-5

# path: the main path whose shape the row is (timed by chip_smoke.py; None:
# checked only); scale: K1's softmax scale on that path (None: 1 / sqrt(D)),
# checked beside the default
FA = namedtuple("FA", "B Hq Hkv Sq Sk D dtype causal path scale", defaults=(None, None))
FA_CASES = [FA(*c) for c in [
    # qwen3_4b's prefill shape, and chatglm3_6b's (32 q-heads, 2 KV heads padded to 16)
    (2, 32, 16, 1024, 1024, 128, torch.bfloat16, True, "qwen3_4b"),
    (1, 8, 4, 1024, 1024, 128, torch.bfloat16, True, "tp_forward"),  # llama3_8b TP-4, a rank
    (2, 32, 32, 1024, 1024, 128, torch.bfloat16, True, "qwen1_5_4b"),  # prefill (MHA)
    # gemma_2b (head dim 256, 1 KV head padded to 16): its prefill, a TP-4
    # rank's shape and a DP-2 rank's (the dp_forward phase)
    (2, 16, 16, 1024, 1024, 256, torch.bfloat16, True, "gemma_2b"),
    (1, 4, 4, 1024, 1024, 256, torch.bfloat16, True, "gemma_2b_tp4"),
    (1, 16, 16, 1024, 1024, 256, torch.bfloat16, True, "gemma_2b_dp2"),
    (1, 8, 2, 96, 160, 32, torch.float32, False),  # not a multiple of the tiles
    (1, 8, 2, 96, 160, 32, torch.bfloat16, False),
    (1, 4, 2, 96, 160, 64, torch.bfloat16, True),  # causal Sq < Sk, top-left
    (1, 4, 1, 160, 96, 64, torch.float32, True),  # causal Sq > Sk, top-left
    (1, 2, 2, 256, 256, 128, torch.float32, True),
    (2, 4, 2, 128, 128, 64, torch.bfloat16, True),
    # bf16 edges of the TMA tiles: Sq, Sk past a 128-row tile's end with B*H > 1
    # (rows past a head's end must read as zeros), GQA groups of 4 and 8,
    # causal Sq < Sk and Sq > Sk, and D = 32 and 64
    (2, 8, 2, 200, 330, 128, torch.bfloat16, True),
    (2, 8, 1, 330, 200, 64, torch.bfloat16, True),
    (2, 16, 4, 257, 257, 128, torch.bfloat16, False),
    (2, 8, 1, 100, 100, 32, torch.bfloat16, True),
    # D = 256 (two consumer warpgroups on a 128-row q-tile, 80-key KV tiles,
    # O stored from registers): Sq, Sk past a tile with B*H > 1, causal Sq < Sk
    # and Sq > Sk, non-causal, MQA (Hkv = 1), and the f32 path; Sq ending
    # inside the second consumer's rows (100) or just past a q-tile (130),
    # causal Sq < Sk and Sq > Sk across a 128-row boundary, Sk no multiple
    # of the KV tile (130, 200)
    (2, 4, 2, 200, 330, 256, torch.bfloat16, True),
    (2, 4, 1, 330, 200, 256, torch.bfloat16, True),
    (2, 8, 2, 257, 257, 256, torch.bfloat16, False),
    (2, 8, 1, 128, 128, 256, torch.bfloat16, True),
    (2, 4, 1, 100, 100, 256, torch.bfloat16, True),
    (1, 4, 2, 130, 200, 256, torch.bfloat16, True),
    (2, 2, 1, 200, 130, 256, torch.bfloat16, True),
    (1, 4, 4, 100, 200, 256, torch.bfloat16, False),
    (2, 4, 2, 130, 130, 256, torch.bfloat16, False),
    (1, 4, 1, 100, 160, 256, torch.float32, True),
    (1, 2, 2, 96, 130, 256, torch.float32, False),
    # D = 80 (D=128's tiles, columns 80-127 zero-filled by TMA): hubert_xlarge's
    # prefill (non-causal MHA) and a TP-4 rank's shape; Sq, Sk past a tile
    # with B*H > 1, causal Sq < Sk and Sq > Sk, GQA, MQA, non-causal, and the
    # f32 path
    (2, 16, 16, 1024, 1024, 80, torch.bfloat16, False, "hubert_xlarge"),
    (2, 4, 4, 1024, 1024, 80, torch.bfloat16, False),
    (2, 4, 2, 200, 330, 80, torch.bfloat16, True),
    (2, 4, 1, 330, 200, 80, torch.bfloat16, True),
    (2, 8, 2, 257, 257, 80, torch.bfloat16, False),
    (2, 8, 1, 128, 128, 80, torch.bfloat16, True),
    (1, 4, 1, 100, 160, 80, torch.float32, True),
    (1, 2, 2, 96, 130, 80, torch.float32, False),
    # internvl2_26b's prefill: 48 q-heads over 8 KV heads padded to 16 (G = 3)
    (2, 48, 16, 1024, 1024, 128, torch.bfloat16, True, "internvl2_26b"),
    # granite_moe_3b (head dim 64, 24 q-heads over 8 KV heads padded to 32
    # over 16): its prefill and a TP-4 rank's shape (the tp_forward phase)
    (2, 32, 16, 1024, 1024, 64, torch.bfloat16, True, "granite_moe_3b"),
    (1, 8, 4, 1024, 1024, 64, torch.bfloat16, True, "granite_moe_3b_tp4"),
    # llama3_8b at TP 2 (32 q-heads over 8 KV heads padded to 16, half a
    # rank): a rank of the tpdp_forward and pipeline_forward phases
    (1, 16, 8, 1024, 1024, 128, torch.bfloat16, True, "tpdp_forward"),
    # moonshot_v1_16b's prefill (MHA, 16 heads)
    (2, 16, 16, 1024, 1024, 128, torch.bfloat16, True, "moonshot_v1_16b"),
    # granite-4.0-h-small's prefill of 8 x 4096 (32 q-heads over 8 KV heads,
    # G = 4) at its own softmax scale, 1/128, and at the default as well
    (8, 32, 8, 4096, 4096, 128, torch.bfloat16, True, "granite_4_0_h_small", 1 / 128),
    # granite's scale at head dims 64 and 256 and on a ragged tile
    (2, 32, 16, 1024, 1024, 64, torch.bfloat16, True, None, 1 / 128),
    (2, 16, 16, 1024, 1024, 256, torch.bfloat16, True, None, 1 / 128),
    (1, 8, 2, 200, 200, 128, torch.bfloat16, True, None, 1 / 128),
]]
RN = namedtuple("RN", "rows D dtype path", defaults=(None,))
RN_CASES = [
    RN(2048, 2560, torch.bfloat16, "qwen3_4b"),  # d_model rows of a (2, 1024) prefill
    RN(2 * 32 * 1024, 128, torch.bfloat16, "qwen3_4b_qnorm"),  # its q-norm rows
    RN(7, 512, torch.float32),  # a row count that is no power of two
    RN(7, 512, torch.bfloat16),
]
# draw: "mamba2" draws dt = softplus(N(0, 1) + dt_bias) with dt_bias and A as
# Mamba-2 initializes them; "slow" draws dt uniform in [1e-3, 1e-2] and A =
# -exp(N(0, 1)), so that a chunk of 128 keeps about half its state (median
# exp(-0.7)) and the carry between chunks shows.
SSD = namedtuple("SSD", "B S H P N chunk dtype draw path", defaults=(None,))
SSD_CASES = [SSD(*c) for c in [
    (4, 4096, 32, 64, 128, 128, torch.bfloat16, "mamba2", "mamba2_130m"),  # its prefill
    # granite-4.0-h-small's benchmark cell: 8 x 4096, 128 heads
    (8, 4096, 128, 64, 128, 128, torch.bfloat16, "mamba2", "granite_4_0_h_small"),
    (1, 5, 2, 16, 8, 128, torch.float32, "mamba2"),  # S < chunk: q = 5
    (2, 3, 4, 32, 16, 128, torch.float32, "mamba2"),  # q = 3
    (1, 100, 2, 64, 128, 128, torch.float32, "mamba2"),  # q = 100, past one half-chunk
    (1, 96, 3, 16, 24, 32, torch.float32, "slow"),  # 3 chunks, N not a multiple of 16
    (2, 256, 4, 32, 64, 64, torch.float32, "slow"),  # 4 chunks
    (2, 2048, 8, 64, 128, 128, torch.float32, "slow"),  # 16 chunks: the carry case
    (2, 2048, 8, 64, 128, 128, torch.bfloat16, "slow"),
    # the bf16 path's other shapes: Jamba's head dim (H=128, P=128, N=128),
    # q = 100 and 3 ragged chunks, N not a multiple of 16, P = 16; P = 128 in f32
    (1, 2048, 128, 128, 128, 128, torch.bfloat16, "slow"),
    (1, 100, 2, 64, 128, 128, torch.bfloat16, "mamba2"),
    (1, 300, 3, 32, 40, 100, torch.bfloat16, "slow"),
    (1, 96, 3, 16, 24, 32, torch.bfloat16, "slow"),
    (2, 256, 4, 16, 64, 64, torch.bfloat16, "mamba2"),
    (1, 256, 4, 128, 64, 64, torch.float32, "slow"),
]]
# The Mamba-2 mixer's fused conv (kernels/causal_conv.py): B, S, the channels
# of each input (x, B and C), taps, dtype, bias
Conv = namedtuple("Conv", "B S widths K dtype bias path", defaults=(None,))
CONV_CASES = [
    # granite-4.0-h-small's benchmark cell: 8 x 4096, x 8192 wide, biases
    Conv(8, 4096, (8192, 128, 128), 4, torch.bfloat16, True, "granite_4_0_h_small"),
    Conv(8, 4096, (8192, 128, 128), 4, torch.float32, True),
    # mamba2_130m's prefill (inner width 1536 padded to 2048, no bias)
    Conv(4, 4096, (2048, 128, 128), 4, torch.bfloat16, False, "mamba2_130m"),
    Conv(4, 4096, (2048, 128, 128), 4, torch.float32, False),
    # sequences shorter than the taps, a sequence no block of 256 rows
    # divides (with and without bias), one input alone, the largest and the
    # smallest tap count
    *(Conv(B, S, widths, K, dtype, bias)
      for B, S, widths, K, bias in [(3, 3, (64, 16, 16), 4, True), (2, 1, (8, 8), 2, False),
                                    (3, 1001, (520, 24, 136), 3, True),
                                    (1, 300, (256,), 8, False), (2, 513, (32, 16, 16), 1, True)]
      for dtype in (torch.bfloat16, torch.float32)),
    Conv(3, 1001, (520, 24, 136), 3, torch.float32, False),
]
# The Mamba-2 mixer's skip and gated norm (kernels/skip_gated_norm.py): B, S,
# heads, head size, the norm's group, dtype
SGN = namedtuple("SGN", "B S H P group dtype path", defaults=(None,))
SGN_CASES = [SGN(*c) for c in [
    # granite-4.0-h-small's benchmark cell: 8 x 4096, 8192 channels, one group
    (8, 4096, 128, 64, 8192, torch.bfloat16, "granite_4_0_h_small"),
    # mamba2_130m's prefill (inner width 1536 padded to 2048), a group a head
    (4, 4096, 32, 64, 64, torch.bfloat16, "mamba2_130m"),
    (3, 1001, 16, 64, 128, torch.bfloat16),  # ragged: odd S, group 128
    (2, 257, 32, 64, 64, torch.float32),
    (1, 300, 128, 64, 8192, torch.float32),  # granite's width in f32
    # the CPU tests' (width, group) pairs: (256, 128), (128, 32), a TP-2 rank
    # of mamba2_130m (1024, 64); jamba_1_5_large's mixer (16384, 128: 16
    # units a thread); 1536 channels (a second pass of the block's threads
    # over half the row); four groups wider than a warp (2048, 512); granite's
    # SMOKE (head 16, group 128)
    (2, 100, 4, 64, 128, torch.bfloat16),
    (2, 100, 8, 16, 32, torch.bfloat16),
    (2, 512, 16, 64, 64, torch.bfloat16),
    (1, 512, 128, 128, 128, torch.bfloat16),
    (2, 64, 24, 64, 64, torch.bfloat16),
    (2, 300, 32, 64, 512, torch.bfloat16),
    (2, 64, 16, 16, 128, torch.float32),
]]
# The capacity dispatch's gather and combine (kernels/moe_dispatch.py), in
# f32 and bf16: arch, tokens (B, S), expert-parallel (rank, size) or None,
# the zoo's padded experts.  granite's prefill layer as the benchmark runs it
# (40 experts, C = 8,192), a D = 4096 layer, a token count no block divides,
# an EP rank.
Dispatch = namedtuple("Dispatch", "arch tokens ep padded path", defaults=(None,))
DISPATCH_CASES = [
    Dispatch("granite_moe_3b", (16, 2048), None, False, "granite_moe_3b"),
    Dispatch("mixtral_8x7b", (2, 1024), None, True),
    Dispatch("granite_moe_3b", (1, 1001), None, True),
    Dispatch("granite_moe_3b", (2, 1024), (2, 4), True),
]


def close(out, ref, tol) -> float:
    """Max abs error of ``out`` against ``ref``; raises unless it is finite,
    within allclose at rtol = atol = ``tol[0]`` and within relative RMS error
    ``tol[1]``, or, for ``tol`` None, unless it equals ``ref`` bit for bit."""
    if tol is None:
        if not torch.equal(out, ref):
            raise AssertionError("kernel differs from its plain version")
        return 0.0
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output has non-finite values")
    err = (out - ref).abs().max().item()
    rel = ((out - ref).norm() / ref.norm()).item()
    if not torch.allclose(out, ref, rtol=tol[0], atol=tol[0]) or rel > tol[1]:
        raise AssertionError(f"kernel disagrees with its plain version: max abs err "
                             f"{err}, rel rms err {rel}, tol {tol}")
    return err


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def fa_inputs(gen, c: FA) -> tuple:
    """q, k, v of a FA_CASES row, N(0, 1)."""
    return (randn(gen, (c.B, c.Hq, c.Sq, c.D), c.dtype),
            randn(gen, (c.B, c.Hkv, c.Sk, c.D), c.dtype),
            randn(gen, (c.B, c.Hkv, c.Sk, c.D), c.dtype))


def rn_inputs(gen, c: RN) -> tuple:
    """x and scale of a RN_CASES row, N(0, 1)."""
    return randn(gen, (c.rows, c.D), c.dtype), randn(gen, (c.D,), c.dtype)


def mamba2_dt_A(gen: torch.Generator, shape) -> tuple[torch.Tensor, torch.Tensor]:
    """``dt_bias`` and ``A_log`` as Mamba-2 draws them (state-spaces/mamba,
    mamba_ssm/modules/mamba2.py): dt log-uniform in [dt_min, dt_max] =
    [1e-3, 1e-1], floored at 1e-4, ``dt_bias`` its inverse softplus; A
    uniform in A_init_range = [1, 16]."""
    dev = gen.device
    u = torch.rand(shape, generator=gen, device=dev)
    dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3)).clamp_min(1e-4)
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    A = torch.rand(shape, generator=gen, device=dev) * 15.0 + 1.0
    return dt_bias, torch.log(A)


def ssd_inputs(gen, c: SSD) -> tuple:
    """x, dt, A, Bm, Cm of a SSD_CASES row (see there for ``draw``)."""
    x = randn(gen, (c.B, c.S, c.H, c.P), c.dtype)
    Bm = randn(gen, (c.B, c.S, c.N), c.dtype)
    Cm = randn(gen, (c.B, c.S, c.N), c.dtype)
    if c.draw == "mamba2":
        dt_bias, A_log = mamba2_dt_A(gen, (c.H,))
        dt = torch.nn.functional.softplus(randn(gen, (c.B, c.S, c.H), torch.float32) + dt_bias)
        A = -torch.exp(A_log)
    else:
        dt = torch.rand((c.B, c.S, c.H), generator=gen, device=gen.device) * 9e-3 + 1e-3
        A = -torch.exp(randn(gen, (c.H,), torch.float32))
    return x, dt, A, Bm, Cm


def ssd_restarted(x, dt, A, Bm, Cm, *, chunk: int):
    """The plain scan with every chunk started from a zero state: what a
    kernel that dropped the carry between chunks would give."""
    B, S, H, P = x.shape
    q = ssd.chunk_len(S, chunk)
    n = B * (S // q)
    y = ssd.ssd_scan_plain(x.reshape(n, q, H, P), dt.reshape(n, q, H), A,
                           Bm.reshape(n, q, -1), Cm.reshape(n, q, -1), chunk=q)
    return y.reshape(B, S, H, P)


def conv_inputs(gen, c: Conv) -> list:
    """``(x, w, b)`` of each input of a CONV_CASES row, N(0, 1), with exact
    zeros in x (signed zero products); b None without bias."""
    convs = []
    for C in c.widths:
        x = randn(gen, (c.B, c.S, C), c.dtype)
        x[:, ::7, ::3] = 0.0
        convs.append((x, randn(gen, (c.K, C), c.dtype),
                      randn(gen, (C,), c.dtype) if c.bias else None))
    return convs


def sgn_inputs(gen, c: SGN) -> tuple:
    """y, x, D, z, s of a SGN_CASES row: N(0, 1) draws (y and D in f32, the
    rest in the row's dtype), with exact zeros in x."""
    W = c.H * c.P
    x = randn(gen, (c.B, c.S, c.H, c.P), c.dtype)
    x[:, ::7, :, ::3] = 0.0
    return (randn(gen, (c.B, c.S, c.H, c.P), torch.float32), x,
            randn(gen, (c.H,), torch.float32), randn(gen, (c.B, c.S, W), c.dtype),
            randn(gen, (W,), c.dtype))


def _sgn_groups(y, x, D, z, group):
    """The plain version's gated product, f32, cut into its groups (B, S,
    groups, channels), as ``gated_rmsnorm`` cuts it."""
    B, S, H, P = y.shape
    W = H * P
    u = (y + D[..., None] * x.float()).reshape(B, S, W).to(x.dtype)
    g = (u * torch.nn.functional.silu(z.float()).to(x.dtype)).float()
    return g.reshape(B, S, -1, sgn.group_of(W, group))


def sgn_rstd(y, x, D, z, *, eps, group):
    """Each group's rstd as the plain version computes it, (B, S, groups)."""
    g = _sgn_groups(y, x, D, z, group)
    if g.shape[2] == 1:  # gated_rmsnorm's one-group branch reduces the row itself
        g = g[:, :, 0]
    return torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + eps).reshape(*g.shape[:2], -1)


def sgn_given_rstd(y, x, D, z, s, rstd):
    """The plain version's arithmetic with each group's rstd given."""
    g = _sgn_groups(y, x, D, z, z.shape[-1] // rstd.shape[-1])
    return (g * rstd[..., None]).reshape(*z.shape).to(x.dtype) * s


def sgn_check(args, got, rstd, *, eps, group, tol) -> float:
    """Hold the kernel's ``got`` and ``rstd`` on ``args`` to the plain
    version (see SGN_TOL, SGN_ULPS, SGN_RSTD_TOL); returns the max abs error
    against it."""
    if not torch.equal(got, sgn_given_rstd(*args, rstd)):
        raise AssertionError("kernel differs from the plain arithmetic given its rstd")
    want_rstd = sgn_rstd(*args[:4], eps=eps, group=group)
    rel = ((rstd - want_rstd).abs() / want_rstd).max().item()
    if rel > SGN_RSTD_TOL:
        raise AssertionError(f"rstd off by {rel} relative (tol {SGN_RSTD_TOL})")
    want = ssm.skip_gated_norm_plain(*args, eps=eps, group=group)
    agree = (rstd == want_rstd)[..., None].expand(*rstd.shape, got.shape[-1] // rstd.shape[-1])
    agree = agree.reshape(got.shape)
    if not torch.equal(got[agree], want[agree]):
        raise AssertionError("kernel differs from its plain version where rstd agrees")
    gap = ulps(got, want)
    if gap > SGN_ULPS[got.dtype]:
        raise AssertionError(f"kernel {gap} ulps off its plain version (tol {SGN_ULPS[got.dtype]})")
    return close(got, want, tol)


def ulps(out, ref) -> float:
    """The largest gap of ``out`` from ``ref``, in ulps of their dtype at the
    larger of the two magnitudes."""
    o, r = out.float(), ref.float()
    _, e = torch.frexp(torch.maximum(o.abs(), r.abs()))
    ulp = torch.exp2((e - 1).float()) * torch.finfo(ref.dtype).eps
    return ((o - r).abs() / ulp).max().item()


def dispatch_layer(arch, dtype, cf, *, device="cpu", tokens=(2, 16), seed=0, smoke=True,
                   padded=True, skew=0.0):
    """One MoE layer's config, parameters and input; ``padded=False`` sets
    the zoo's padded experts back to the published count (granite: 40).
    ``skew`` adds one N(0, skew^2) vector to every token: the router then
    favours some experts over all tokens, so capacity drops pairs, as in a
    model whose tokens route alike (independent N(0, 1) tokens load 40
    experts so evenly that capacity 1.25 drops none at 32,768 tokens)."""
    cfg = dataclasses.replace(get_config(arch, smoke=smoke), capacity_factor=cf)
    if not padded:
        cfg = dataclasses.replace(cfg, n_experts_padded=0)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = mlp.moe_init(gen, cfg, dtype=dtype)
    x = torch.randn((*tokens, cfg.d_model), generator=gen, device=device)
    x = x + skew * torch.randn((cfg.d_model,), generator=gen, device=device)
    return cfg, p, x.to(dtype)


def ep_rank(p, ep, device="cpu"):
    """(context, parameters) of one expert-parallel rank, ``ep`` = (rank,
    size): its slice of the expert stacks; the single device's for ``ep``
    None.  Its combine's partial sum goes through ``psum_ep``."""
    if ep is None:
        return ParallelCtx.single(), p
    rank, size = ep
    n = p["wg"].shape[0] // size
    mine = {k: v[rank * n:(rank + 1) * n] for k, v in p.items() if k in ("wg", "wu", "wo")}
    return (ParallelCtx(ep_axis="model", ep_size=size,
                        rank=torch.tensor(rank, dtype=torch.int64, device=device)),
            {**p, **mine})


@contextlib.contextmanager
def recorded_dispatch():
    """Record, by kernel name, the arguments of each ``ops.moe_gather`` and
    ``ops.moe_combine`` call made inside; the calls go through unchanged."""
    seen = {}
    calls = {name: getattr(ops, name) for name in ("moe_gather", "moe_combine")}

    def recorder(name):
        def rec(*args):
            seen[name] = args
            return calls[name](*args)
        return rec

    try:
        for name in calls:
            setattr(ops, name, recorder(name))
        yield seen
    finally:
        for name, fn in calls.items():
            setattr(ops, name, fn)
