"""Context-parallel decode in the port against the JAX package's.

``CP_TEMPLATE``'s case (``tests/test_tp_equivalence.py``): jamba_1_5_large
SMOKE in f32, batch 2, ``max_len`` 32, on four gloo CPU ranks as a (data,
model) mesh whose data axis is the context-parallel one, at tp 2 x cp 2
and at tp 1 x cp 4.  Each rank keeps its (head, sequence) shard of the
single-device caches (``cache_specs(..., cp="data")``) and runs
``spmd.cp_decode``.  The gathered logits are held to the JAX package's
single-device ``decode_step`` and to its CP decode under ``jax.vmap`` over
("data", "model"), by ``CP_TEMPLATE``'s criterion and by a tight f32 bound.
Cases: ``CP_TEMPLATE``'s zero caches at position 5 (shard 0 writes), and
caches filled with random K/V and SSM state at a position that a shard
other than rank 0's owns; each runs three steps, so later steps attend
over the K/V the owning shard wrote.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.parallel.ctx import ParallelCtx as JParallelCtx  # noqa: E402
from repro.parallel.sharding import param_specs as jparam_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402

ARCH = "jamba_1_5_large"
B, MAXLEN, STEPS = 2, 32, 3
MESHES = [(2, 2), (1, 4)]  # (tp, cp)
# (name, first position, random caches): position 21 is owned by shard 1
# of cp 2 (16 positions a shard) and shard 2 of cp 4 (8 a shard)
CASES = [("zeros_pos5", 5, False), ("random_pos21", 21, True)]
# f32: the largest error over the logits' scale.  The CP merge sums the
# shards' partial softmax in another order than one device's loop; the
# first reading (this CPU) was at most 5.96e-6 over every mesh, case and
# step (2.0e-6 to 5.7e-6 against the single device, 2.0e-6 to 6.0e-6
# against JAX's CP), so the bound is about 3x that
F32_REL = 2e-5


def _cfgs():
    return (dataclasses.replace(jax_config(ARCH, smoke=True), dtype="float32"),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32"))


def _random_caches(jm, seed):
    """Single-device caches with every leaf drawn (K/V past the position
    included: the mask must hide them)."""
    zeros = jm.init_cache(B, MAXLEN)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.5 * rng.standard_normal(a.shape), a.dtype), zeros)


def _jax_reference(jm, params, caches, tokens, start):
    """One device: ``STEPS`` decode steps from ``start``."""
    out = []
    step = jax.jit(jm.decode_step)
    for t in range(STEPS):
        logits, caches = step(params, tokens[:, t], caches, jnp.int32(start + t))
        out.append(np.asarray(logits))
    return np.stack(out)


def _cache_shard(a, path_leaf, d, m, tp, cp):
    """The (model-head, data-sequence) shard of a stacked cache leaf, as
    ``cache_specs(..., cp="data")`` cuts it."""
    if path_leaf in ("k", "v"):  # (nb, B, Hkv, S, hd)
        h, s = a.shape[2] // tp, a.shape[3] // cp
        return a[:, :, m * h:(m + 1) * h, d * s:(d + 1) * s]
    if path_leaf == "state":  # (nb, B, H, P, N)
        h = a.shape[2] // tp
        return a[:, :, m * h:(m + 1) * h]
    if path_leaf == "conv_x":  # (nb, B, K-1, C)
        c = a.shape[3] // tp
        return a[..., m * c:(m + 1) * c]
    return a


def _jax_cp(jcfg, params, caches, tokens, start, tp, cp):
    """JAX's CP decode: ``decode_step`` of a (model, data)-axis context
    under ``jax.vmap`` over "data" (sequence shards) and "model" (heads and
    experts), ``STEPS`` steps; logits indexed [step, data, model]."""
    md = JaxModel(jcfg, JParallelCtx(tp_axis="model", tp_size=tp, ep_axis="model",
                                     ep_size=tp, cp_axis="data", cp_size=cp))
    specs = jparam_specs(jax.eval_shape(lambda: params))

    def shard(a, spec, m):
        for dim, ax in enumerate(tuple(spec)):
            if ax == "model":
                n = a.shape[dim] // tp
                a = jax.lax.slice_in_dim(a, m * n, (m + 1) * n, axis=dim)
        return a

    stacked = jax.tree_util.tree_map(
        lambda a, s: jnp.stack([shard(a, s, m) for m in range(tp)]), params, specs)
    local = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.stack([jnp.stack([
            _cache_shard(a, str(getattr(path[-1], "key", "")), d, m, tp, cp)
            for m in range(tp)]) for d in range(cp)]), caches)
    f = jax.jit(jax.vmap(jax.vmap(lambda p, c, tok, pos: md.decode_step(p, tok, c, pos),
                                  in_axes=(0, 0, None, None), axis_name="model"),
                         in_axes=(None, 0, None, None), axis_name="data"))
    out = []
    for t in range(STEPS):
        logits, local = f(stacked, local, tokens[:, t], jnp.int32(start + t))
        out.append(np.asarray(logits))
    return np.stack(out)  # (T, cp, tp, B, V_loc)


def _ranks(rank, world, cases):
    """Every mesh and case of this file on one rank."""
    out = {}
    for (tp, cp), runs in cases.items():
        for name, (cfg, params, tokens, start, caches) in runs.items():
            out[(tp, cp, name)] = spmd.cp_decode(rank, world, cfg, params, tokens, start,
                                                 caches, tp, device="cpu")
    return out


@pytest.fixture(scope="module")
def readings():
    jcfg, cfg = _cfgs()
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    # CP_TEMPLATE's first token ids (arange(B) + 3), then two more steps
    tokens = (np.arange(B)[:, None] + 3 + 7 * np.arange(STEPS)[None]).astype(np.int32)
    want, port_cases, jax_cp = {}, {}, {}
    for name, start, rand in CASES:
        caches = _random_caches(jm, 3) if rand else jm.init_cache(B, MAXLEN)
        want[name] = _jax_reference(jm, params, caches, tokens, start)
        for tp, cp in MESHES:
            jax_cp[(tp, cp, name)] = _jax_cp(jcfg, params, caches, tokens, start, tp, cp)
            port_cases.setdefault((tp, cp), {})[name] = (
                cfg, params_from_jax(params), torch.from_numpy(tokens.astype(np.int64)),
                start, params_from_jax(caches))
    ranks = spmd.run(_ranks, 4, (port_cases,), timeout=600)
    return want, jax_cp, ranks


def _gathered(ranks, key, tp, cp):
    """The port's logits (T, B, V): every CP replica of a vocab shard agrees
    bit for bit; the shards concatenated in model order."""
    by = {(r[key]["data"], r[key]["model"]): r[key]["logits"].numpy() for r in ranks}
    assert set(by) == {(d, m) for d in range(cp) for m in range(tp)}
    for d in range(1, cp):
        for m in range(tp):
            np.testing.assert_array_equal(by[(d, m)], by[(0, m)])
    return np.concatenate([by[(0, m)] for m in range(tp)], axis=-1)


def _check(got, want, what):
    scale = max(float(want.std()), 1.0)
    bad = np.mean(np.abs(got - want) / scale > 0.1)
    assert bad < 0.02, f"{what}: {bad:.2%} of logits off by more than 0.1 of their scale"
    rel = float(np.abs(got - want).max()) / scale
    assert rel < F32_REL, f"{what}: max error {rel:.3g} of the scale"


@pytest.mark.parametrize("name", [c[0] for c in CASES])
@pytest.mark.parametrize("tp,cp", MESHES, ids=["tp2xcp2", "tp1xcp4"])
def test_cp_decode_equals_one_device_and_jax_cp(readings, tp, cp, name):
    want, jax_cp, ranks = readings
    got = _gathered(ranks, (tp, cp, name), tp, cp)
    assert got.shape == want[name].shape
    _check(got, want[name], "port CP vs JAX single-device")
    jcp = jax_cp[(tp, cp, name)]
    for d in range(cp):
        _check(got, np.concatenate([jcp[:, d, m] for m in range(tp)], axis=-1),
               f"port vs JAX CP (data {d})")


def test_prefill_caches_from_forward_decode_as_the_sequence():
    """The cp_decode phase's setup on the card (``chip_smoke.prefill_caches``):
    the K/V that ``Model.forward`` collects through ``kv_out`` fill caches
    from which ``decode_step`` at the next position gives the forward's
    logits over the longer sequence (llama3_8b SMOKE, 2 layers, f32)."""
    import importlib.util
    import pathlib

    from repro_torch.models import Model

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = dataclasses.replace(get_config("llama3_8b", smoke=True), dtype="float32",
                              n_layers=2)
    model = Model(cfg, impl="reference", device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (B, 7)))
    with torch.no_grad():
        caches = chip_smoke.prefill_caches(model, params, tokens[:, :6], MAXLEN)
        logits, _ = model.decode_step(params, tokens[:, 6], caches, 6)
        want = model.forward(params, {"tokens": tokens})[:, 6]
    err = ((logits - want).abs().max() / want.abs().max()).item()
    print(f"prefill_caches decode vs forward: {err:.3g} of the logits' scale")
    assert err < F32_REL
