"""The Mamba-2 mixer's skip and gated norm (``csrc/skip_gated_norm.cu``) on
the CPU: its plain version, ``models/ssm.py`` ``skip_gated_norm_plain``, the
arithmetic the card test holds the kernel to, ``ssm_fwd``'s routing, and the
wrappers' refusals.

- ``card_cases.sgn_given_rstd`` on the plain version's own rstd
  (``card_cases.sgn_rstd``) equals the plain version bit for bit, in float32
  and bfloat16, over granite-4.0-h's one group of 8192 channels, mamba2_130m's
  groups of 64 over 2048, a TP-2 rank's half of that, and groups of 128 over
  256 and of 32 over 128: the card test's oracle is the plain version's
  arithmetic.
- ``ssm_fwd(impl="kernel")`` runs the plain version once after the scan on
  the CPU, handing it the scan's output, the conv's x, ``Dskip``, z and the
  norm's scale, and gives the reference path's output bit for bit once both
  paths share a scan, on granite-4.0-h-small's and mamba2_130m's SMOKE mixers.
- The wrappers refuse autograd-tracked inputs, a tensor off a Hopper device,
  mismatched shapes, a group that does not divide the width or that the
  kernel's reductions cannot cut, and dtypes they do not take.

The kernel against its plain version on the card:
``test_torch_card_kernels.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import card_cases as cases  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import skip_gated_norm as sgn  # noqa: E402
from repro_torch.models import Model, ssm  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EPS = 1e-5


def _inputs(B, S, H, P, dtype, seed=0):
    """y, x, D, z, s as ``card_cases.sgn_inputs`` draws them, on the CPU."""
    c = cases.SGN(B, S, H, P, 0, dtype)
    return cases.sgn_inputs(torch.Generator().manual_seed(seed), c)


# (heads, head size, group): widths 8192, 2048, 1024 (a TP-2 rank of 2048),
# 256 and 128
SHAPES = [(128, 64, 8192), (32, 64, 64), (16, 64, 64), (4, 64, 128), (8, 16, 32)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,P,group", SHAPES)
def test_card_check_arithmetic_equals_the_plain(H, P, group, dtype):
    args = _inputs(2, 3, H, P, DTYPES[dtype])
    want = ssm.skip_gated_norm_plain(*args, eps=EPS, group=group)
    assert want.dtype == DTYPES[dtype] and want.shape == (2, 3, H * P)
    rstd = cases.sgn_rstd(*args[:4], eps=EPS, group=group)
    assert rstd.shape == (2, 3, H * P // group)
    assert torch.equal(cases.sgn_given_rstd(*args, rstd), want)
    cases.sgn_check(args, want, rstd, eps=EPS, group=group, tol=cases.SGN_TOL[DTYPES[dtype]])


def _mixer(arch, dtype, B=2, S=32):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    params = Model(cfg, impl="kernel", device="cpu").init(torch.Generator().manual_seed(1))
    p = tree_map(lambda a: a[0], params["blocks"][0]["ssm"])
    gen = torch.Generator().manual_seed(2)  # the init's ones would hide a misplaced D or scale
    p["Dskip"].copy_(torch.randn(p["Dskip"].shape, generator=gen))
    p["out_norm"]["s"].copy_(torch.randn(p["out_norm"]["s"].shape, generator=gen))
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(3))
    return cfg, p, x.to(DTYPES[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ["granite_4_0_h_small", "mamba2_130m"])
def test_ssm_fwd_kernel_path_equals_the_parents(arch, dtype, monkeypatch):
    cfg, p, x = _mixer(arch, dtype)
    seen, scans = [], []
    plain, scan = ssm.skip_gated_norm_plain, ops.ssd_scan

    def record_scan(*args, **kw):
        scans.append(scan(*args, **kw))
        return scans[-1]

    def record(*args, **kw):
        seen.append((args, kw))
        return plain(*args, **kw)

    monkeypatch.setattr(ops, "ssd_scan", record_scan)
    monkeypatch.setattr(ssm, "skip_gated_norm_plain", record)
    with torch.no_grad():
        got = ssm.ssm_fwd(cfg, ParallelCtx.single(), p, x, impl="kernel")
    assert len(seen) == 1 and len(scans) == 1
    (y, xh, D, z, s), kw = seen[0]
    assert y is scans[0] and s is p["out_norm"]["s"] and torch.equal(D, p["Dskip"])
    assert kw == {"eps": cfg.norm_eps, "group": ssm._norm_group(cfg, z.shape[-1])}
    assert xh.shape == y.shape and z.shape == (*x.shape[:2], cfg.d_inner_p)

    # the reference path, given the kernel path's scan, runs the same lines
    monkeypatch.setattr(ssm, "ssd_chunked", lambda *a, **kw: scans[0])
    with torch.no_grad():
        want = ssm.ssm_fwd(cfg, ParallelCtx.single(), p, x, impl="reference")
    assert len(seen) == 2 and got.dtype == want.dtype and torch.equal(got, want)


def _refused(case):
    """(callable, exception type, message) for one refusal case."""
    y, x, D, z, s = _inputs(2, 4, 4, 64, torch.bfloat16)
    wide = _inputs(1, 1, 520, 64, torch.bfloat16)
    return {
        "autograd": (lambda: ops.skip_gated_norm(y.requires_grad_(), x, D, z, s, eps=EPS,
                                                 group=64), RuntimeError,
                     "skip_gated_norm kernel has no backward"),
        "cpu_tensor": (lambda: sgn.skip_gated_norm(y, x, D, z, s, eps=EPS, group=64),
                       ValueError, "CUDA tensor"),
        "shapes": (lambda: sgn.skip_gated_norm(y, x, D, z[:, :, :128], s, eps=EPS, group=64),
                   ValueError, "shapes do not match"),
        "y_not_4d": (lambda: sgn.skip_gated_norm(z, x, D, z, s, eps=EPS, group=64),
                     ValueError, "y must be"),
        "group_divides": (lambda: sgn.skip_gated_norm(y, x, D, z, s, eps=EPS, group=48),
                          ValueError, "does not divide the width 256"),
        "group_cut": (lambda: sgn.skip_gated_norm(*_inputs(1, 2, 6, 64, torch.bfloat16),
                                                  eps=EPS, group=96),
                      ValueError, "group 96"),
        "width": (lambda: sgn.skip_gated_norm(*wide, eps=EPS, group=0), ValueError,
                  "widths up to 16384"),
        "float16": (lambda: sgn.skip_gated_norm(y, x.half(), D, z.half(), s.half(), eps=EPS,
                                                group=64), ValueError, "float32 or bfloat16"),
        "mixed_dtypes": (lambda: sgn.skip_gated_norm(y, x, D, z.float(), s, eps=EPS,
                                                     group=64), ValueError, "share a dtype"),
        "y_bf16": (lambda: sgn.skip_gated_norm(y.bfloat16(), x, D, z, s, eps=EPS, group=64),
                   ValueError, "y and D must be float32"),
    }[case]


@pytest.mark.parametrize("case", ["autograd", "cpu_tensor", "shapes", "y_not_4d",
                                  "group_divides", "group_cut", "width", "float16",
                                  "mixed_dtypes", "y_bf16"])
def test_wrappers_refuse(case):
    fn, err, match = _refused(case)
    with pytest.raises(err, match=match):
        fn()
    assert sgn.skip_gated_norm.launches == 0


def test_outside_grad_mode_tracked_inputs_are_taken():
    args = _inputs(2, 4, 4, 64, torch.float32)
    # past the autograd guard, up to the device check (the card only)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        ops.skip_gated_norm(args[0].requires_grad_(), *args[1:], eps=EPS, group=64)
    assert sgn.skip_gated_norm.launches == 0
