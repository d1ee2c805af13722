"""On the card (marked ``card``; elsewhere they skip): each hand-written kernel
against its plain version, over every row of its table in ``card_cases.py``.

- K1 (``flash_attention``) within ``FA_TOL`` at the default softmax scale
  and, where the row gives one, through ``ops.flash_attention`` at that
  scale;
- K2 (``rmsnorm``) within ``RN_TOL``;
- K3 (``ssd_scan``) within ``SSD_TOL``; on a "slow" row whose state crosses
  chunks, the scan restarted at every chunk lies far outside that limit, so
  a kernel that dropped the carry would fail the row;
- the Mamba-2 mixer's fused conv (``causal_conv``) bit for bit, one launch
  for all of a row's inputs;
- the capacity dispatch's ``moe_gather`` and ``moe_combine``, in f32 and
  bf16, each bit for bit on the arguments ``moe_fwd(impl="kernel")`` gave it,
  and that layer bit for bit the reference's dispatch; the rows' routing
  keeps rows, leaves rows empty and drops pairs;
- the Mamba-2 mixer's skip and gated norm (``skip_gated_norm``) bit for bit
  the plain arithmetic given its own rstd of each group, bit for bit the
  plain version in each group whose rstd agrees, and within ``SGN_TOL``,
  ``SGN_ULPS`` and ``SGN_RSTD_TOL`` elsewhere."""
import pytest

torch = pytest.importorskip("torch")

import card_cases as cases  # noqa: E402
from card_cases import (CONV_CASES, DISPATCH_CASES, FA_CASES, FA_TOL, RN_CASES,  # noqa: E402
                        RN_TOL, SGN_CASES, SGN_EPS, SGN_TOL, SSD_CASES, SSD_TOL)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import skip_gated_norm as sgn  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs a CUDA device of compute capability (9, 0)")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("c", FA_CASES, ids=str)
def test_card_flash_attention_equals_plain(hopper, c):
    q, k, v = cases.fa_inputs(torch.Generator(device=hopper).manual_seed(1), c)
    cases.close(fa.flash_attention(q, k, v, causal=c.causal),
                fa.flash_attention_plain(q, k, v, causal=c.causal), FA_TOL[c.dtype])
    if c.scale is not None:
        cases.close(ops.flash_attention(q, k, v, causal=c.causal, scale=c.scale),
                    fa.flash_attention_plain(q, k, v, causal=c.causal, scale=c.scale),
                    FA_TOL[c.dtype])


@pytest.mark.card
@pytest.mark.parametrize("c", RN_CASES, ids=str)
def test_card_rmsnorm_equals_plain(hopper, c):
    x, s = cases.rn_inputs(torch.Generator(device=hopper).manual_seed(2), c)
    cases.close(rn.rmsnorm(x, s), rn.rmsnorm_plain(x, s), RN_TOL[c.dtype])


@pytest.mark.card
@pytest.mark.parametrize("c", SSD_CASES, ids=str)
def test_card_ssd_scan_equals_plain(hopper, c):
    args = cases.ssd_inputs(torch.Generator(device=hopper).manual_seed(3), c)
    want = ssd.ssd_scan_plain(*args, chunk=c.chunk)
    cases.close(ssd.ssd_scan(*args, chunk=c.chunk), want, SSD_TOL)
    if c.draw == "slow" and c.S > ssd.chunk_len(c.S, c.chunk):
        restarted = cases.ssd_restarted(*args, chunk=c.chunk)
        assert ((restarted - want).norm() / want.norm()).item() > 100 * SSD_TOL[1]


@pytest.mark.card
@pytest.mark.parametrize("c", CONV_CASES, ids=str)
def test_card_causal_conv_equals_plain(hopper, c):
    convs = cases.conv_inputs(torch.Generator(device=hopper).manual_seed(5), c)
    n = cc.causal_conv.launches
    got = cc.causal_conv(*convs)
    torch.cuda.synchronize()
    assert cc.causal_conv.launches - n == 1
    for y, want in zip(got, cc.causal_conv_plain(*convs)):
        assert y.dtype == c.dtype and torch.equal(y, want)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("c", DISPATCH_CASES, ids=str)
def test_card_moe_dispatch_equals_plain(hopper, c, dtype, monkeypatch):
    cfg, p, x = cases.dispatch_layer(c.arch, dtype, get_config(c.arch).capacity_factor,
                                     device=hopper, tokens=c.tokens, smoke=False,
                                     padded=c.padded, skew=0.5)
    ctx, p = cases.ep_rank(p, c.ep, hopper)
    # a rank's combine alone: its partial sum before the all_reduce
    monkeypatch.setattr(ParallelCtx, "psum_ep", lambda self, x: x)
    want = mlp.moe_fwd(cfg, ctx, p, x)
    n = md.moe_gather.launches, md.moe_combine.launches
    with cases.recorded_dispatch() as seen:
        got = mlp.moe_fwd(cfg, ctx, p, x, impl="kernel")
    torch.cuda.synchronize()
    assert (md.moe_gather.launches - n[0], md.moe_combine.launches - n[1]) == (1, 1)
    assert torch.equal(got, want)
    xf, src = seen["moe_gather"]
    assert torch.equal(md.moe_gather(xf, src), md.moe_gather_plain(xf, src))
    eout, slot, w, local = seen["moe_combine"]
    assert torch.equal(md.moe_combine(eout, slot, w, local),
                       md.moe_combine_plain(eout, slot, w, local))
    # kept rows, empty rows and dropped (or remote) pairs
    assert (src < 0).any() and (src >= 0).any() and not local.all()


@pytest.mark.card
@pytest.mark.parametrize("c", SGN_CASES, ids=str)
def test_card_skip_gated_norm_equals_plain(hopper, c):
    args = cases.sgn_inputs(torch.Generator(device=hopper).manual_seed(7), c)
    n = sgn.skip_gated_norm.launches
    got, rstd = sgn.skip_gated_norm(*args, eps=SGN_EPS, group=c.group, rstd=True)
    torch.cuda.synchronize()
    assert sgn.skip_gated_norm.launches - n == 1
    W = c.H * c.P
    assert got.dtype == c.dtype and rstd.shape == (c.B, c.S, W // sgn.group_of(W, c.group))
    cases.sgn_check(args, got, rstd, eps=SGN_EPS, group=c.group, tol=SGN_TOL[c.dtype])
