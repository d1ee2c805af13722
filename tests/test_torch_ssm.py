"""The port's SSM modules on the CPU against the JAX package: ``ssd_chunked``,
``gated_rmsnorm``, ``_causal_conv`` and the decode recurrence, on the same
numpy inputs and weights.  The SSD scan itself (plain version, oracle) is
held in tests/test_torch_kernels.py."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import modules as jmodules  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.parallel.ctx import ParallelCtx as JaxCtx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import modules, ssm  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402
from test_torch_kernels import SSD_SHAPES, SSD_TOL, _np, _pair, _ssd_ref, ssd_inputs  # noqa: E402

# bf16 results that round at the same sites may still differ by one bf16 ulp
# (2^-8 relative) where an f32 intermediate differs in its last bit
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
# one compiled program per shape instead of one per jnp op
_ssd_chunked = jax.jit(jssm.ssd_chunked, static_argnums=5, static_argnames="return_state")


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_chunked_port_vs_jax(shape):
    """y and the final state against the JAX ``ssd_chunked`` and the
    recurrence, at tests/test_kernels.py's tolerance."""
    *dims, chunk, slow = shape
    arrays = ssd_inputs(*dims, slow)
    j = [jnp.asarray(a) for a in arrays]
    y, state = ssm.ssd_chunked(*(torch.from_numpy(a) for a in arrays), chunk,
                               return_state=True)
    jy, jstate = _ssd_chunked(*j, chunk, return_state=True)
    np.testing.assert_allclose(_np(y), _np(jy), **SSD_TOL)
    np.testing.assert_allclose(_np(y), _np(_ssd_ref(*j)), **SSD_TOL)
    np.testing.assert_allclose(_np(state), _np(jstate), **SSD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [0, 32])
def test_gated_rmsnorm_vs_jax(dtype, group):
    rng = np.random.default_rng(5)
    (jx, tx), (jz, tz), (js, ts) = (
        _pair(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((2, 7, 128), (2, 7, 128), (128,)))
    got = modules.gated_rmsnorm({"s": ts}, tx, tz, 1e-5, group=group)
    want = jmodules.gated_rmsnorm({"s": js}, jx, jz, 1e-5, group=group)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_vs_jax(dtype):
    rng = np.random.default_rng(6)
    (jx, tx), (jw, tw) = (_pair(rng.standard_normal(s).astype(np.float32), dtype)
                          for s in ((2, 11, 48), (4, 48)))
    got = ssm._causal_conv(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(jssm._causal_conv(jx, jw)), **TOL[dtype])


@functools.cache
def _ssm_case(chunk: int = 4, B: int = 2, S: int = 16):
    """mamba2_130m SMOKE in f32 with ``ssm_chunk`` cut so that S spans
    several chunks; one layer's weights from the JAX ``ssm_init``, and
    inputs of scale 0.1 as in tests/test_kernels.py."""
    jcfg = dataclasses.replace(jax_config("mamba2_130m", smoke=True), ssm_chunk=chunk)
    tcfg = dataclasses.replace(get_config("mamba2_130m", smoke=True), ssm_chunk=chunk)
    key = jax.random.PRNGKey(3)
    jp = jax.tree_util.tree_map(
        lambda a: a[0], jssm.ssm_init(key, jcfg, stacked=(1,), dtype=jnp.float32))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(7).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, 0.1 * x


@functools.cache
def _jax_ssm_fwd():
    jcfg, _, jp, _, x = _ssm_case()
    return jax.jit(functools.partial(jssm.ssm_fwd, jcfg, JaxCtx.single()))(jp, jnp.asarray(x))


_jax_ssm_decode = jax.jit(functools.partial(jssm.ssm_decode, _ssm_case()[0], JaxCtx.single()))


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_ssm_fwd_matches_jax(impl):
    jcfg, tcfg, jp, tp, x = _ssm_case()
    want = _jax_ssm_fwd()
    got = ssm.ssm_fwd(tcfg, ParallelCtx.single(), tp, torch.from_numpy(x), impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    assert ssd.ssd_scan.launches == 0


def test_ssd_decode_state_consistency():
    """Sequential decode steps reproduce the full-sequence SSD output across
    four chunks (tests/test_kernels.py's check, at its tolerance), and the
    decode caches equal the JAX decode's."""
    jcfg, tcfg, jp, tp, x = _ssm_case()
    B, S, _ = x.shape
    ctx = ParallelCtx.single()
    tx = torch.from_numpy(x)
    cache = ssm.ssm_init_cache(tcfg, B, dtype=torch.float32)
    jcache = jssm.ssm_init_cache(jcfg, B, dtype=jnp.float32)
    outs = []
    for t in range(S):
        y, cache = ssm.ssm_decode(tcfg, ctx, tp, tx[:, t:t + 1], cache)
        _, jcache = _jax_ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache)
        outs.append(y)
    dec = _np(torch.cat(outs, dim=1))
    for impl in ("kernel", "reference"):
        full = _np(ssm.ssm_fwd(tcfg, ctx, tp, tx, impl=impl))
        np.testing.assert_allclose(dec, full, rtol=2e-3, atol=2e-3)
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_ssm_fwd_sequence_not_a_multiple_of_the_chunk_raises(impl):
    _, tcfg, _, tp, x = _ssm_case(chunk=4, S=6)
    with pytest.raises(ValueError, match="multiple"):
        ssm.ssm_fwd(tcfg, ParallelCtx.single(), tp, torch.from_numpy(x), impl=impl)
