"""The port's kernel module on the CPU: plain versions of the flash-attention,
RMSNorm and SSD-scan kernels held to the JAX oracles and to the Pallas kernels
run in interpret mode, and the torch oracles held to the JAX oracles.  Inputs come
from numpy with a fixed seed.  On the CPU the public ops take the plain
versions and no kernel is launched."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

SHAPES = [  # tests/test_kernels.py's flash-attention shapes
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 128, 128, 64),
    (1, 4, 1, 64, 256, 64),
    (1, 2, 2, 256, 256, 128),
    (1, 8, 2, 96, 160, 32),
]
DTYPES = ["float32", "bfloat16"]
# one compiled program per shape instead of one per jnp op
_attention_ref = jax.jit(jref.attention_ref, static_argnames="causal")
_rmsnorm_ref = jax.jit(jref.rmsnorm_ref)
_ssd_ref = jax.jit(jref.ssd_ref)


def _tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounds the same
    f32 values to nearest even in both)."""
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _qkv(B, Hq, Hkv, Sq, Sk, D, dtype, seed=7):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s).astype(np.float32), dtype)
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _assert_no_launch():
    assert fa.flash_attention.launches == 0
    assert rn.rmsnorm.launches == 0
    assert ssd.ssd_scan.launches == 0


# causal with Sq != Sk: the kernels align the mask top-left, the oracle
# bottom-right, so those cases are held to the interpret kernel only
_VS_REF = [(s, d, c) for s in SHAPES for d in DTYPES for c in (True, False)
           if not (c and s[3] != s[4])]


@pytest.mark.parametrize("shape,dtype,causal", _VS_REF)
def test_flash_plain_vs_jax_ref(shape, dtype, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(*shape, dtype)
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    want = _attention_ref(jq, jk, jv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))
    _assert_no_launch()


_VS_INTERPRET = (
    [(s, "float32", False) for s in SHAPES]
    + [(s, "bfloat16", True) for s in SHAPES[:2]]
    + [(s, d, True) for s in SHAPES if s[3] != s[4] for d in DTYPES]
)


@pytest.mark.parametrize("shape,dtype,causal", _VS_INTERPRET)
def test_flash_plain_vs_pallas_interpret(shape, dtype, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(*shape, dtype)
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                                interpret=True)
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))
    _assert_no_launch()


# gemma_2b's head dim: MQA (1 KV head) and its padded MHA, ragged and not,
# both dtypes; causal Sq != Sk against the interpret kernel only (see above).
# The last two end inside the card kernel's second 128-row q-tile with Sk no
# multiple of its 64-key tiles, Sq < Sk and Sq > Sk
D256 = [(1, 4, 1, 96, 96, 256), (1, 2, 2, 64, 160, 256), (2, 2, 1, 160, 64, 256),
        (1, 2, 1, 130, 200, 256), (1, 2, 2, 200, 130, 256)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", D256)
def test_flash_plain_head_dim_256(shape, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(*shape, dtype, seed=11)
    causal = shape[3] == shape[4]
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(_attention_ref(jq, jk, jv, causal=causal)),
                               **_tol(dtype))
    want = jops.flash_attention(jq, jk, jv, causal=True, block_q=64, block_k=64,
                                interpret=True)
    np.testing.assert_allclose(_np(ops.flash_attention(tq, tk, tv, causal=True)),
                               _np(want), **_tol(dtype))
    _assert_no_launch()


# hubert_xlarge's head dim (d_model 1280 over 16 heads), no multiple of a
# 64-column tile: MHA non-causal as hubert runs it, GQA and MQA, ragged and
# not; causal Sq != Sk against the interpret kernel only (see above)
D80 = [(2, 4, 4, 96, 96, 80), (1, 4, 2, 64, 160, 80), (2, 2, 1, 160, 64, 80)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", D80)
def test_flash_plain_head_dim_80(shape, dtype, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(*shape, dtype, seed=13)
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    if not (causal and shape[3] != shape[4]):
        np.testing.assert_allclose(
            _np(out), _np(_attention_ref(jq, jk, jv, causal=causal)), **_tol(dtype))
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                                interpret=True)
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))
    _assert_no_launch()


def test_flash_wrapper_takes_head_dims(monkeypatch):
    """Past the device check, the wrapper takes every D of HEAD_DIMS,
    gemma_2b's 256 and hubert_xlarge's 80 included, and refuses the others
    (a D the kernel lacks, 96, and one past its tiles, 512)."""
    monkeypatch.setattr(fa.build, "require_hopper", lambda t: None)
    assert 256 in fa.HEAD_DIMS and 80 in fa.HEAD_DIMS
    for D in fa.HEAD_DIMS:
        (_, tq), (_, tk), (_, tv) = _qkv(1, 2, 1, 8, 8, D, "bfloat16")
        fa._check(tq, tk, tv)
    for bad in (96, 512):
        (_, tq), (_, tk), (_, tv) = _qkv(1, 2, 1, 8, 8, bad, "bfloat16")
        with pytest.raises(ValueError, match="head dim"):
            fa._check(tq, tk, tv)


@pytest.mark.parametrize("shape", [(1, 4, 2, 64, 160, 32), (1, 4, 2, 160, 64, 32),
                                   (1, 2, 2, 64, 64, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_port_matches_jax(shape, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(*shape, "float32", seed=3)
    np.testing.assert_allclose(_np(ref.attention_ref(tq, tk, tv, causal=causal)),
                               _np(_attention_ref(jq, jk, jv, causal=causal)),
                               rtol=2e-5, atol=2e-5)


RN_SHAPES = [(4, 128), (2, 64, 256), (1, 7, 512)]


def _xs(shape, dtype, seed=1):
    rng = np.random.default_rng(seed)
    return (_pair(rng.standard_normal(shape).astype(np.float32), dtype),
            _pair(rng.standard_normal(shape[-1]).astype(np.float32), dtype))


@pytest.mark.parametrize("shape", RN_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plain_vs_jax(shape, dtype):
    (jx, tx), (js, ts) = _xs(shape, dtype)
    out = ops.rmsnorm(tx, ts)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    np.testing.assert_allclose(_np(out), _np(_rmsnorm_ref(jx, js)), **_tol(dtype))
    np.testing.assert_allclose(
        _np(out), _np(jops.rmsnorm(jx, js, interpret=True, block_rows=8)), **_tol(dtype))
    np.testing.assert_allclose(_np(ref.rmsnorm_ref(tx, ts)), _np(_rmsnorm_ref(jx, js)),
                               **_tol(dtype))
    _assert_no_launch()


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers launch or raise; they never compute on the CPU."""
    (_, tq), (_, tk), (_, tv) = _qkv(1, 2, 2, 64, 64, 32, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(tq, tk, tv)
    (_, tx), (_, ts) = _xs((4, 128), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(tx, ts)
    _assert_no_launch()


def test_ops_raise_off_cpu_without_kernel():
    """A tensor that is neither on the CPU nor on a Hopper card is refused."""
    q = torch.empty((1, 2, 64, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm(torch.empty((4, 128), device="meta"), torch.empty(128, device="meta"))
    _assert_no_launch()


# tests/test_kernels.py's SSD shapes (B, S, H, P, N, chunk), then a case whose
# chunks carry their state: dt uniform in [1e-3, 1e-2] keeps about
# exp(-0.35) of it across a chunk of 64 (the others forget it within a chunk)
SSD_SHAPES = [
    (1, 128, 2, 32, 16, 32, False),
    (2, 256, 3, 64, 32, 64, False),
    (1, 64, 1, 16, 8, 64, False),  # single chunk
    (1, 512, 2, 32, 128, 128, False),  # full state width
    (1, 256, 2, 128, 64, 128, True),  # Jamba's head dim P=128, two chunks
    (2, 256, 3, 64, 32, 64, True),  # slow decay, four chunks
]
# tests/test_kernels.py's SSD tolerance: f32 sums taken in another order
SSD_TOL = dict(rtol=5e-4, atol=5e-4)


def ssd_inputs(B, S, H, P, N, slow: bool, seed: int = 0):
    """numpy x, dt (post-softplus), A (negative), Bm, Cm, drawn as
    tests/test_kernels.py draws them; ``slow`` draws dt uniform in
    [1e-3, 1e-2] instead."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    if slow:
        dt = rng.uniform(1e-3, 1e-2, (B, S, H)).astype(np.float32)
    else:
        dt = np.logaddexp(rng.standard_normal((B, S, H)), 0.0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _ssd_pairs(arrays, dtype: str):
    """JAX arrays and torch tensors of the same values; x, Bm and Cm in
    ``dtype``, dt and A in f32 (as the models pass them)."""
    x, dt, A, Bm, Cm = arrays
    (jx, tx), (jb, tb), (jc, tc) = (_pair(a, dtype) for a in (x, Bm, Cm))
    return ((jx, jnp.asarray(dt), jnp.asarray(A), jb, jc),
            (tx, torch.from_numpy(dt), torch.from_numpy(A), tb, tc))


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_plain_vs_pallas_interpret(shape, dtype):
    """Both widen bf16 inputs to f32 first, so bf16 takes the f32 tolerance."""
    *dims, chunk, slow = shape
    j, t = _ssd_pairs(ssd_inputs(*dims, slow), dtype)
    out = ops.ssd_scan(*t, chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == t[0].shape
    np.testing.assert_allclose(
        _np(out), _np(jops.ssd_scan(*j, chunk=chunk, interpret=True)), **SSD_TOL)
    np.testing.assert_allclose(_np(out), _np(_ssd_ref(*j)), **SSD_TOL)
    _assert_no_launch()


def test_ssd_slow_decay_case_needs_the_carry():
    """Restarting every chunk from a zero state (a kernel that drops the
    carry) misses the slow-decay case by far more than the tolerance."""
    *dims, chunk, slow = SSD_SHAPES[-1]
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in ssd_inputs(*dims, slow))
    want = ref.ssd_ref(x, dt, A, Bm, Cm)
    restarted = torch.cat([ref.ssd_ref(x[:, c:c + chunk], dt[:, c:c + chunk], A,
                                       Bm[:, c:c + chunk], Cm[:, c:c + chunk])
                           for c in range(0, x.shape[1], chunk)], dim=1)
    assert (restarted - want).abs().max() > 100 * SSD_TOL["atol"]
    np.testing.assert_allclose(_np(ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)),
                               _np(want), **SSD_TOL)


@pytest.mark.parametrize("shape", SSD_SHAPES[:2] + SSD_SHAPES[-1:])
def test_ssd_ref_port_matches_jax(shape):
    """The literal recurrence in both packages: f32, the same order of
    operations step by step."""
    *dims, _, slow = shape
    j, t = _ssd_pairs(ssd_inputs(*dims, slow, seed=4), "float32")
    np.testing.assert_allclose(_np(ref.ssd_ref(*t)), _np(_ssd_ref(*j)),
                               rtol=5e-5, atol=5e-5)


def test_ssd_sequence_not_a_multiple_of_the_chunk_raises():
    _, t = _ssd_pairs(ssd_inputs(1, 96, 1, 16, 8, False), "float32")
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan(*t, chunk=64)
    assert ops.ssd_scan(*t, chunk=128).shape == t[0].shape  # S <= chunk: one chunk
    _assert_no_launch()


def test_ssd_wrapper_refuses_cpu_and_meta_tensors():
    """The kernel's wrapper launches or raises; it never computes on the CPU,
    and ``ops.ssd_scan`` sends only CPU tensors to the plain version."""
    _, t = _ssd_pairs(ssd_inputs(1, 64, 1, 16, 8, False), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan(*t, chunk=64)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_scan(*(a.to("meta") for a in t), chunk=64)
    _assert_no_launch()


@pytest.mark.parametrize("P", [16, 32, 64, 128])
def test_ssd_wrapper_takes_jamba_head_dim(P, monkeypatch):
    """Past the device check, the wrapper takes every P of HEAD_DIMS,
    Jamba's 128 included, and refuses the others."""
    monkeypatch.setattr(ssd.build, "require_hopper", lambda t: None)
    _, t = _ssd_pairs(ssd_inputs(1, 64, 2, P, 16, False), "bfloat16")
    assert ssd._check(*t, chunk=32) == 32
    for bad in (8, 48, 96, 256):
        _, t = _ssd_pairs(ssd_inputs(1, 64, 2, bad, 16, False), "bfloat16")
        with pytest.raises(ValueError, match="head dim"):
            ssd._check(*t, chunk=32)


def _bf16_split(v):
    """v as bf16 hi + lo (hi + lo = v to 2^-18 relative), both widened."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _ssd_split_rehearsal(x, dt, A, Bm, Cm, *, chunk: int, ps: int):
    """The bf16 kernel's arithmetic (csrc/ssd_scan.cu) in plain torch, on
    bf16 x, Bm, Cm: G = C B^T once per (b, chunk); each P-slice of ps
    columns carries its own state; below the diagonal 16-blocks M takes
    exp(cum_i - cum_r) exp(cum_r - cum_j) dt_j with r the last step of j's
    block; every per-head product is two passes, its f32 operand split into
    bf16 hi + lo against an exact bf16 one."""
    Bsz, S, H, P = x.shape
    q = ssd.chunk_len(S, chunk)
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    i = torch.arange(q)
    tri = (i[:, None] >= i[None, :])[None, :, :, None]
    same = (i[:, None] // 16 == i[None, :] // 16)[None, :, :, None]
    r = torch.clamp(i | 15, max=q - 1)
    y = torch.empty((Bsz, S, H, P))
    for p0 in range(0, P, ps):
        state = torch.zeros((Bsz, H, Bm.shape[-1], ps))
        for c in range(S // q):
            sl = slice(c * q, (c + 1) * q)
            xc, bc, cc, dtc = xf[:, sl, :, p0:p0 + ps], Bf[:, sl], Cf[:, sl], dt[:, sl]
            G = torch.einsum("bin,bjn->bij", cc, bc)[..., None]
            cum = torch.cumsum(dtc * A, dim=1)  # (B, q, H)
            ev = torch.exp(cum[:, r] - cum) * dtc
            direct = G * torch.exp(cum[:, :, None] - cum[:, None]) * dtc[:, None]
            factored = G * torch.exp(cum[:, :, None] - cum[:, r][:, None]) * ev[:, None]
            M = torch.where(tri, torch.where(same, direct, factored), 0.0)
            mh, ml = _bf16_split(M)
            sh, sl_ = _bf16_split(state)
            y_diag = (torch.einsum("bijh,bjhp->bihp", mh, xc)
                      + torch.einsum("bijh,bjhp->bihp", ml, xc))
            y_off = torch.exp(cum)[..., None] * (torch.einsum("bin,bhnp->bihp", cc, sh)
                                                 + torch.einsum("bin,bhnp->bihp", cc, sl_))
            y[:, sl, :, p0:p0 + ps] = y_diag + y_off
            wh, wl = _bf16_split((torch.exp(cum[:, -1:] - cum) * dtc)[..., None] * xc)
            state = (state * torch.exp(cum[:, -1])[:, :, None, None]
                     + torch.einsum("bjn,bjhp->bhnp", bc, wh)
                     + torch.einsum("bjn,bjhp->bhnp", bc, wl))
    return y


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_split_rehearsal_matches_pallas(shape):
    """The bf16 kernel's design, rehearsed on the CPU: its hi + lo passes and
    factored decays stay within the f32 tolerance of the Pallas kernel (in
    interpret mode) and of the literal recurrence, and within the chip's
    relative RMS limit (1e-5) of the plain version."""
    *dims, chunk, slow = shape
    j, t = _ssd_pairs(ssd_inputs(*dims, slow), "bfloat16")
    out = _ssd_split_rehearsal(*t, chunk=chunk, ps=min(32, dims[3]))
    np.testing.assert_allclose(
        _np(out), _np(jops.ssd_scan(*j, chunk=chunk, interpret=True)), **SSD_TOL)
    np.testing.assert_allclose(_np(out), _np(_ssd_ref(*j)), **SSD_TOL)
    plain = ops.ssd_scan(*t, chunk=chunk)
    assert ((out - plain).norm() / plain.norm()).item() < 1e-5


def test_ssd_breakdown_edits_apply():
    """scripts/ssd_scan_breakdown.py switches the scan's products off by
    editing csrc/ssd_scan.cu; each edit must name text that occurs once."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "ssd_scan_breakdown", root / "scripts" / "ssd_scan_breakdown.py")
    breakdown = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(breakdown)
    src = (root / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_scan.cu").read_text()
    for name, edits in breakdown.VARIANTS.items():
        for old, new in edits:
            assert src.count(old) == 1, (name, old)
            assert new != old


def test_planted_kernel_fault_edits_apply():
    """scripts/planted_faults.sh plants each kernel fault by replacing text in
    a csrc/ source; that text must occur there once, the second consumer's
    row fault of head dim 256 included."""
    import re
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    script = (root / "scripts" / "planted_faults.sh").read_text()
    faults = re.findall(r"\n    (\w+)\)\n      file=\$csrc/(\S+) .*?\n      old='(.*?)'\n", script,
                        re.DOTALL)
    names = {name for name, _, _ in faults}
    assert {"fa_d256_last_q_box", "fa_d256_second_consumer_rows", "fa_last_kv_stale",
            "ssd_carry_dropped"} <= names
    for name, src, old in faults:
        text = (root / "src" / "repro_torch" / "kernels" / "csrc" / src).read_text()
        assert text.count(old) == 1, (name, old)


def test_ptxas_report_reads_spills_and_notes():
    """chip_smoke's kernel resources line: each kernel's registers, spills and
    the codes of ptxas's notes (C7512: wgmmas serialised), from an nvcc log."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    fn = "_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_728212e114flash_fwd_bf16ILi256EEEvv"
    log = (f"ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async "
           f"instructions are serialized in the function '{fn}'\n"
           f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {fn}\n"
           "    288 bytes stack frame, 1148 bytes spill stores, 964 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 16 barriers\n")
    (row,) = chip_smoke.ptxas_report(log, {"flash_fwd_bf16<256>": 230528})
    assert row == {"function": "flash_fwd_bf16<256>", "dynamic_smem_bytes": 230528,
                   "stack_bytes": 288, "spill_store_bytes": 1148, "registers": 168,
                   "ptxas_notes": ["C7512"]}
