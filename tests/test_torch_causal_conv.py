"""The Mamba-2 mixer's fused causal conv (``kernels/causal_conv.py``,
``csrc/causal_conv.cu``) on the CPU, where the wrappers take the plain
version.

- The plain version equals ``models/ssm.py``'s ``_causal_conv`` followed by
  ``F.silu`` bit for bit: float32 and bfloat16, with and without a bias, 1
  to 4 taps, sequences shorter than the taps, several distinct sequences.
- ``ssm_fwd(impl="kernel")``, which now calls ``ops.causal_conv`` once for
  x, B and C, gives the output it gave with the three ``_causal_conv`` +
  ``F.silu`` lines, bit for bit, on granite-4.0-h-small's and mamba2_130m's
  SMOKE mixers; so do the conv's outputs, recorded as the scan receives
  them.
- The wrappers refuse autograd-tracked inputs, a tensor off a Hopper device,
  a channel count the kernel's 16-byte vectors cannot cut, and shapes or
  tap counts it does not take.

The kernel against its plain version on the card: ``test_torch_card_hybrid.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model, ssm  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _convs(B, S, widths, K, dtype, bias, seed=0):
    """(x, w, b) for each width: N(0, 1) draws in ``dtype``; a few exact
    zeros in x, so that signed zero products occur."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for C in widths:
        x = torch.randn((B, S, C), generator=gen).to(dtype)
        x[:, ::3, ::5] = 0.0
        w = torch.randn((K, C), generator=gen).to(dtype)
        b = torch.randn((C,), generator=gen).to(dtype) if bias else None
        out.append((x, w, b))
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("B,S", [(3, 2), (2, 37), (1, 1)])
def test_plain_equals_causal_conv_then_silu(dtype, bias, K, B, S):
    convs = _convs(B, S, (24, 16, 8), K, DTYPES[dtype], bias)
    got = cc.causal_conv_plain(*convs)
    assert len(got) == 3
    for y, (x, w, b) in zip(got, convs):
        want = F.silu(ssm._causal_conv(x, w, b))
        assert y.dtype == x.dtype and torch.equal(y, want)
    assert all(torch.equal(a, b) for a, b in zip(ops.causal_conv(*convs), got))


def _mixer(arch, dtype, B=2, S=32):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    params = Model(cfg, impl="kernel", device="cpu").init(torch.Generator().manual_seed(1))
    p = tree_map(lambda a: a[0], params["blocks"][0]["ssm"])
    if cfg.ssm_conv_bias:  # the init's zero biases would hide a dropped bias
        gen = torch.Generator().manual_seed(2)
        for leaf in p["conv_bias"].values():
            leaf["b"].copy_(torch.randn(leaf["b"].shape, generator=gen))
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(3))
    return cfg, p, x.to(DTYPES[dtype])


def _parent_convs(*convs):
    """The kernel path's conv before the fused op: three ``_causal_conv``
    and ``F.silu`` pairs."""
    return tuple(F.silu(ssm._causal_conv(*conv)) for conv in convs)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ["granite_4_0_h_small", "mamba2_130m"])
def test_ssm_fwd_kernel_path_equals_the_parents(arch, dtype, monkeypatch):
    cfg, p, x = _mixer(arch, dtype)
    seen, fused = [], ops.causal_conv

    def record(*convs):
        seen.append((convs, fused(*convs)))
        return seen[-1][1]

    monkeypatch.setattr(ops, "causal_conv", record)
    with torch.no_grad():
        got = ssm.ssm_fwd(cfg, ParallelCtx.single(), p, x, impl="kernel")
    assert len(seen) == 1 and len(seen[0][0]) == 3
    convs, outs = seen[0]
    assert [c[1] is p[f"conv_{n}"] for c, n in zip(convs, "xBC")] == [True] * 3
    assert all((c[2] is None) == (not cfg.ssm_conv_bias) for c in convs)
    for y, want in zip(outs, _parent_convs(*convs)):
        assert torch.equal(y, want)
    monkeypatch.setattr(ops, "causal_conv", _parent_convs)
    with torch.no_grad():
        want = ssm.ssm_fwd(cfg, ParallelCtx.single(), p, x, impl="kernel")
    assert got.dtype == want.dtype and torch.equal(got, want)


def _refused(case):
    """(callable, exception type, message) for one refusal case."""
    (x, w, b), (x2, w2, b2) = _convs(2, 8, (16, 8), 4, torch.bfloat16, True)
    f32 = _convs(2, 8, (6,), 4, torch.float32, True)[0]
    odd = _convs(2, 8, (12,), 4, torch.bfloat16, False)[0]
    return {
        "autograd": (lambda: ops.causal_conv((x.requires_grad_(), w, b)), RuntimeError,
                     "causal_conv kernel has no backward"),
        "cpu_tensor": (lambda: cc.causal_conv((x, w, b), (x2, w2, b2)), ValueError,
                       "CUDA tensor"),
        "bf16_channels": (lambda: cc.causal_conv(odd), ValueError,
                          "12 channels are not a multiple of 8"),
        "f32_channels": (lambda: cc.causal_conv(f32), ValueError,
                         "6 channels are not a multiple of 4"),
        "taps": (lambda: cc.causal_conv((x, torch.zeros((9, 16), dtype=x.dtype), b)),
                 ValueError, "9 taps"),
        "four_inputs": (lambda: cc.causal_conv(*[(x, w, b)] * 4), ValueError, "1 to 3 inputs"),
        "mixed_dtypes": (lambda: cc.causal_conv((x, w.float(), b)), ValueError,
                         "must be torch.bfloat16"),
        "other_sequence": (lambda: cc.causal_conv((x, w, b), (x2[:, :4].contiguous(), w2, b2)),
                           ValueError, "do not match"),
    }[case]


@pytest.mark.parametrize("case", ["autograd", "cpu_tensor", "bf16_channels", "f32_channels",
                                  "taps", "four_inputs", "mixed_dtypes", "other_sequence"])
def test_wrappers_refuse(case):
    fn, err, match = _refused(case)
    with pytest.raises(err, match=match):
        fn()


def test_outside_grad_mode_tracked_inputs_are_taken():
    (x, w, b), = _convs(2, 8, (16,), 4, torch.float32, True)
    with torch.no_grad():
        y, = ops.causal_conv((x.requires_grad_(), w, b))
    assert torch.equal(y, F.silu(ssm._causal_conv(x.detach(), w, b)))
