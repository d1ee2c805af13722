"""The port's model on the CPU against the JAX model: the same SMOKE weights
(carried across with ``params_from_jax``) and the same numpy tokens give the
same forward logits, and the same decode logits and caches (KV for attention
layers, SSD state and conv buffers for SSM layers).  The configs cover qkv
biases (qwen1_5_4b), half-dim RoPE with 2 KV heads (chatglm3_6b), GeGLU, MQA
and tied embeddings (gemma_2b) and tied embeddings on a SwiGLU model (a
SMOKE variant with ``tie_embeddings=True``).  The decode position may be a
0-d tensor, as the engine passes it: the same logits and caches as the int,
also where the write wraps or clamps.  The frontends (hubert_xlarge's audio
frames through a non-causal GELU encoder, internvl2_26b's projected patch
prefix before the token embeddings) give the JAX forward's logits from the
same frames or patches; ``input_specs`` and ``skip_reason`` give the JAX
package's records."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.configs import base as jax_base  # noqa: E402
from repro_torch.configs import SHAPES, ArchConfig, get_config, input_specs, skip_reason  # noqa: E402
from repro_torch.configs.base import PORT_FIELDS  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402

ARCHS = ["llama3_8b", "qwen3_4b", "mamba2_130m", "qwen1_5_4b", "chatglm3_6b", "gemma_2b"]
FRONTENDS = ["hubert_xlarge", "internvl2_26b"]
# jamba's SMOKE without experts: a JAX-valid hybrid with attention at layer 2
# of a period of 4 and SSD layers elsewhere, for the mixed cache tuple
HYBRID = "jamba_1_5_large-noexperts"
# llama3_8b's SMOKE with the LM head tied to the embedding (gemma_2b's
# feature, here beside SwiGLU and GQA)
TIED = "llama3_8b-tied"
# f32: summation order only; bf16: the repo's bf16 kernel tolerance
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
# Configs with SSD layers in bf16 are held to relative RMS error instead, one
# limit per kind of quantity.  A bf16 rounding that moves in one layer's
# conv, silu or gated norm grows through the SSD state and the next layers:
# at these SMOKE configs the port differs from the jitted JAX model by up to
# 0.044 in forward logits, 0.048 in decode logits (0.044 and 0.048 at the
# position test's -3 and 9) and 0.038 in a cache leaf, the hybrid's KV
# leaves included; that is JAX's own eager run against its jitted one, to
# which the port's decode step is equal (the KV leaves' max abs error fails
# allclose at 5e-2 in both).  Five planted faults (a reversed conv, an
# ungrouped gated norm, a dropped skip term, an undecayed decode state, a
# conv buffer not written back) move every quantity they touch by at least
# 0.57 (logits) and 0.118 (cache leaves).  The limits sit between the two.
# The JAX model's eager run differs from its jitted one by up to 0.156 in
# the hybrid's forward logits, more than the logit limit: the port's
# forward rounds silu as the jitted model does (modules.silu).
# (tests/ssm_bf16_tolerances.py prints every reading.)  f32 above is the
# exact check for those configs.
SSM_BF16_REL_RMS = {"logits": 0.1, "cache": 0.09}


def _assert_close(got, want, dtype: str, cfg, kind: str = "logits"):
    got, want = _np(got), _np(want)
    if dtype == "bfloat16" and cfg.ssm_state:
        assert got.shape == want.shape
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= SSM_BF16_REL_RMS[kind], rel
    else:
        np.testing.assert_allclose(got, want, **TOL[dtype])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _smoke_configs(arch: str):
    """(JAX config, port config) at SMOKE size."""
    if arch == HYBRID:
        jcfg = dataclasses.replace(jax_config("jamba_1_5_large", smoke=True), n_experts=0)
        return jcfg, ArchConfig(**dataclasses.asdict(jcfg))
    if arch == TIED:
        jcfg = dataclasses.replace(jax_config("llama3_8b", smoke=True), tie_embeddings=True)
        return jcfg, ArchConfig(**dataclasses.asdict(jcfg))
    return jax_config(arch, smoke=True), get_config(arch, smoke=True)


@functools.cache
def _f32_init(arch: str):
    jcfg, _ = _smoke_configs(arch)
    return jax.jit(JaxModel(dataclasses.replace(jcfg, dtype="float32")).init)(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS + [HYBRID, TIED] for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    return _pair(*request.param)


def _pair(arch: str, dtype: str):
    """(JAX model, JAX params, port config, port params) with shared weights.
    Both dtypes take one f32 init, each leaf cast to the type that the
    model's own init gives it (which gives the same values as that init)."""
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in _smoke_configs(arch))
    jm = JaxModel(jcfg)
    types = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda a, t: a.astype(t.dtype), _f32_init(arch), types)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tcfg, tp, dtype


def _tokens(B=2, S=24, vocab=256, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def test_config_port_matches_jax():
    for arch in ARCHS + FRONTENDS:  # TIED and HYBRID are built from the JAX config itself
        for smoke in (False, True):
            j = dataclasses.asdict(jax_config(arch, smoke=smoke))
            t = dataclasses.asdict(get_config(arch, smoke=smoke))
            # the port's own fields, which the JAX package lacks, at their defaults
            own = {k: t.pop(k) for k in PORT_FIELDS}
            assert own == {f.name: f.default for f in dataclasses.fields(ArchConfig)
                           if f.name in PORT_FIELDS}
            assert j == t
            jc, tc = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
            assert (jc.hd, jc.heads, jc.kv_heads, jc.vocab_p, jc.block_period,
                    jc.param_count()) == (tc.hd, tc.heads, tc.kv_heads, tc.vocab_p,
                                          tc.block_period, tc.param_count())
            assert (jc.d_inner_p, jc.ssm_heads_p) == (tc.d_inner_p, tc.ssm_heads_p)
            assert ([jc.is_attn_layer(i) for i in range(jc.n_layers)]
                    == [tc.is_attn_layer(i) for i in range(tc.n_layers)])


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_forward_matches_jax(pair, impl):
    jm, jp, tcfg, tp, dtype = pair
    toks = _tokens()
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got = Model(tcfg, impl=impl, device="cpu").forward(
        tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    _assert_close(got, want, dtype, tcfg)
    assert fa.flash_attention.launches == 0 and ssd.ssd_scan.launches == 0


def test_kernel_impl_matches_reference(pair):
    _, _, tcfg, tp, dtype = pair
    batch = {"tokens": torch.from_numpy(_tokens(S=40, seed=1)).long()}
    a = Model(tcfg, impl="kernel", device="cpu").prefill(tp, batch)
    b = Model(tcfg, impl="reference", device="cpu").forward(tp, batch)
    np.testing.assert_allclose(_np(a), _np(b), **TOL[dtype])


@pytest.mark.parametrize("max_len", [8, 4])  # 4: positions 4, 5 clamp the write
def test_decode_matches_jax(pair, max_len):
    jm, jp, tcfg, tp, dtype = pair
    tm = Model(tcfg, device="cpu")
    toks = _tokens(S=6, seed=2)
    jcache = jm.init_cache(2, max_len)
    tcache = tm.init_cache(2, max_len)
    step = jax.jit(jm.decode_step)
    for t in range(6):
        jlog, jcache = step(jp, jnp.asarray(toks[:, t]), jcache, jnp.int32(t))
        tlog, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, t]).long(), tcache, t)
        _assert_close(tlog, jlog, dtype, tcfg)
    assert len(tcache) == len(jcache) == tcfg.block_period
    for jc, tc in zip(jcache, tcache):
        assert sorted(tc) == sorted(jc)
        for name in jc:
            assert tuple(tc[name].shape) == jc[name].shape
            _assert_close(tc[name], jc[name], dtype, tcfg, "cache")


@pytest.mark.parametrize("position", [-3, 9])  # wraps once; past max_len: clamps
@pytest.mark.parametrize("arch", ARCHS + [HYBRID, TIED])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_position_matches_int_and_jax(dtype, arch, position):
    """The engine's 0-d tensor position gives the int position's logits and
    caches, bit for bit, in both dtypes, and both follow
    ``lax.dynamic_update_slice_in_dim`` as the JAX model does, at the
    tolerances above: a negative position counts from the end once, a
    position past the buffer writes its last slot."""
    jm, jp, tcfg, tp, _ = _pair(arch, dtype)
    tm = Model(tcfg, device="cpu")
    toks = _tokens(S=3, seed=4)
    jcache = jm.init_cache(2, 6)
    caches = {kind: tm.init_cache(2, 6) for kind in ("int", "tensor")}
    step = jax.jit(jm.decode_step)
    for t in range(2):  # two steps at 0, 1, then the one under test
        tok = torch.from_numpy(toks[:, t]).long()
        jlog, jcache = step(jp, jnp.asarray(toks[:, t]), jcache, jnp.int32(t))
        for kind in caches:
            _, caches[kind] = tm.decode_step(tp, tok, caches[kind], t)
    tok = torch.from_numpy(toks[:, 2]).long()
    ilog, icache = tm.decode_step(tp, tok, caches["int"], position)
    tlog, tcache = tm.decode_step(tp, tok, caches["tensor"], torch.tensor(position))
    assert tlog.dtype == getattr(torch, dtype) and torch.equal(ilog, tlog)
    for ic, tc in zip(icache, tcache):
        assert sorted(ic) == sorted(tc)
        for name in ic:
            assert torch.equal(ic[name], tc[name])
    jlog, jcache = step(jp, jnp.asarray(toks[:, 2]), jcache, jnp.int32(position))
    _assert_close(tlog, jlog, dtype, tcfg)
    for jc, tc in zip(jcache, tcache):
        for name in jc:
            _assert_close(tc[name], jc[name], dtype, tcfg, "cache")


def test_out_of_range_tokens_match_jax(pair):
    """jnp.take's default: a negative id counts from the end, an id past the
    vocabulary gives NaN logits at its position."""
    jm, jp, tcfg, tp, dtype = pair
    toks = np.array([[3, -1, 300, 7], [-256, 255, 256, -257]], np.int32)
    want = _np(jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)}))
    got = _np(Model(tcfg, device="cpu").forward(tp, {"tokens": torch.from_numpy(toks).long()}))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    # causal attention spreads a NaN row to the later positions (an SSD chunk
    # to all its positions, through NaN * 0 in its masked scores); compare
    # the positions before the first invalid id
    np.testing.assert_allclose(got[0, :2], want[0, :2], **TOL[dtype])


def _frontend_batch(cfg, B=2, S=24, seed=5):
    """(JAX batch, port batch) for a frontend arch: frames over the whole
    sequence (audio), or a patch prefix and S - frontend_len tokens
    (vision); the float inputs in the config's dtype, the same values in
    both."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        parts = {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    else:
        parts = {"vision_embeds": rng.standard_normal(
                     (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32),
                 "tokens": _tokens(B, S - cfg.frontend_len, cfg.vocab, seed)}
    jb = {k: jnp.asarray(v).astype(cfg.dtype) if v.dtype == np.float32 else jnp.asarray(v)
          for k, v in parts.items()}
    tb = {k: torch.from_numpy(v).to(getattr(torch, cfg.dtype)) if v.dtype == np.float32
          else torch.from_numpy(v).long() for k, v in parts.items()}
    return jb, tb


def _frontend_pair(arch: str, dtype: str):
    """``_pair`` with ``vis_proj``'s bias drawn at random (the JAX init
    zeroes it), so that the prefix's bias add shows."""
    jm, jp, tcfg, tp, dtype = _pair(arch, dtype)
    if "vis_proj" in jp:
        b = np.random.default_rng(9).standard_normal(jp["vis_proj"]["b"].shape) * 0.5
        jp = {**jp, "vis_proj": {**jp["vis_proj"], "b": jnp.asarray(b, jp["vis_proj"]["b"].dtype)}}
        tp = {**tp, "vis_proj": params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp["vis_proj"]), "cpu")}
    return jm, jp, tcfg, tp, dtype


@pytest.mark.parametrize("impl", ["kernel", "reference"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_forward_matches_jax(arch, dtype, impl):
    """hubert_xlarge: frames through 2 non-causal layers (GELU MLPs) and
    the 64-row head; internvl2_26b: ``vis_proj`` (with bias) of 8 patch
    embeddings before 16 token embeddings, through 2 causal GQA layers."""
    jm, jp, tcfg, tp, dtype = _frontend_pair(arch, dtype)
    assert ("vis_proj" in tp) == (tcfg.frontend == "vision_patches")
    jb, tb = _frontend_batch(tcfg)
    want = jax.jit(jm.forward)(jp, jb)
    got = Model(tcfg, impl=impl, device="cpu").forward(tp, tb)
    assert got.shape == want.shape == (2, 24, tcfg.vocab_p)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got, want, dtype, tcfg)
    assert fa.flash_attention.launches == 0


@pytest.mark.parametrize("impl", ["kernel", "reference"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_full_width_forward_matches_jax(dtype, impl):
    """hubert_xlarge at its published widths (d_model 1280, 16 heads of
    80, the GELU MLP's 5120, the 512-row head), cut to one layer: the
    same weights and frames (2, 32) give the JAX forward's logits."""
    jcfg = dataclasses.replace(jax_config("hubert_xlarge"), n_layers=1)
    jm = JaxModel(dataclasses.replace(jcfg, dtype=dtype))
    f32 = jax.jit(JaxModel(dataclasses.replace(jcfg, dtype="float32")).init)(
        jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda a, t: a.astype(t.dtype), f32,
                                jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tcfg = ArchConfig(**dataclasses.asdict(jm.cfg))
    jb, tb = _frontend_batch(tcfg, S=32)
    want = jax.jit(jm.forward)(jp, jb)
    got = Model(tcfg, impl=impl, device="cpu").forward(tp, tb)
    assert got.shape == want.shape == (2, 32, 512)
    _assert_close(got, want, dtype, tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_internvl_full_width_prefix_matches_jax(dtype):
    """internvl2_26b's first hidden states at its published widths:
    ``vis_proj`` (3200 -> 6144, a random bias) of 256 patches before 32
    token embeddings, as the JAX model forms them.  The embedding table
    has 1024 of the vocabulary's rows, enough for these tokens."""
    jcfg = dataclasses.replace(jax_config("internvl2_26b"), dtype=dtype)
    tcfg = ArchConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(3)
    d, f = jcfg.d_model, jcfg.frontend_dim
    weights = {"embed": {"w": rng.standard_normal((1024, d)) * 0.02},
               "vis_proj": {"w": rng.standard_normal((f, d)) / np.sqrt(f),
                            "b": rng.standard_normal(d) * 0.5}}
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), weights)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jb, tb = _frontend_batch(dataclasses.replace(tcfg, vocab=1024), B=1,
                             S=jcfg.frontend_len + 32)
    want = jax.jit(JaxModel(jcfg)._inputs_to_hidden)(jp, jb)
    got = Model(tcfg, device="cpu")._inputs_to_hidden(tp, tb)
    assert got.shape == want.shape == (1, 288, 6144)
    _assert_close(got, want, dtype, tcfg, kind="hidden")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_vision_prefix_is_the_decode_step(dtype):
    """internvl2_26b with a prefix of no patches, (1, 0, frontend_dim): the
    forward gives the JAX forward's logits and, at every position, the
    logits of ``decode_step`` fed the same tokens one at a time (the check
    the serve phase makes on the card)."""
    jm, jp, tcfg, tp, dtype = _frontend_pair("internvl2_26b", dtype)
    toks = _tokens(1, 6, tcfg.vocab, seed=6)
    empty = np.zeros((1, 0, tcfg.frontend_dim), np.float32)
    want = jax.jit(jm.forward)(jp, {"vision_embeds": jnp.asarray(empty).astype(dtype),
                                    "tokens": jnp.asarray(toks)})
    model = Model(tcfg, device="cpu")
    got = model.prefill(tp, {"vision_embeds": torch.from_numpy(empty).to(getattr(torch, dtype)),
                             "tokens": torch.from_numpy(toks).long()})
    _assert_close(got, want, dtype, tcfg)
    caches = model.init_cache(1, 8)
    for t in range(toks.shape[1]):
        step, caches = model.decode_step(tp, torch.from_numpy(toks[:, t]).long(), caches, t)
        _assert_close(step, got[:, t], dtype, tcfg)


@pytest.mark.parametrize("arch", ["qwen3_4b", "internvl2_26b"])
def test_dropped_weights_are_freed_without_the_cyclic_collector(arch):
    """A model's weights go when the caller drops them, after a prefill and
    a decode step, with no cyclic garbage collection (a reference cycle
    kept a full-width model's block weights alive on the card until the
    collector ran, and internvl2_26b's weights did not fit beside them)."""
    import gc
    import weakref

    cfg = get_config(arch, smoke=True)
    gc.disable()
    try:
        model = Model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        watched = [weakref.ref(params["blocks"][0]["ln1"]["s"]),
                   weakref.ref(params["embed"]["w"])]
        _, tb = _frontend_batch(cfg) if cfg.frontend != "none" else (
            None, {"tokens": torch.from_numpy(_tokens(S=8)).long()})
        with torch.inference_mode():
            model.prefill(params, tb)
            model.decode_step(params, torch.tensor([1, 2]), model.init_cache(2, 8), 0)
        del model, params
        assert all(w() is None for w in watched)
    finally:
        gc.enable()


def test_input_specs_and_skips_match_jax():
    """Every ported arch x shape cell: the same input names, shapes and
    dtypes as the JAX ``input_specs``, and the same skip strings."""
    import importlib.util

    archs = [a for a in jax_base.ARCH_IDS + jax_base.EXTRA_IDS
             if importlib.util.find_spec(f"repro_torch.configs.{a}")]
    assert set(ARCHS + FRONTENDS) <= set(archs)
    assert list(SHAPES) == list(jax_base.SHAPES)
    for arch in archs:
        cfg, jcfg = get_config(arch), jax_config(arch)
        for shape in SHAPES:
            assert skip_reason(cfg, shape) == jax_base.skip_reason(jcfg, shape)
            got, want = input_specs(cfg, shape), jax_base.input_specs(jcfg, shape)
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in got.items()} == {
                k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert skip_reason(get_config("hubert_xlarge"), "decode_32k") == (
        "encoder-only architecture has no decode step")


def test_unported_families_and_missing_gpu_raise():
    cfg = get_config("qwen3_4b", smoke=True)
    # every family is ported: experts (dense MoE, and a jamba-like hybrid
    # with experts) and the frontends construct
    for change in ({"ssm_state": 16, "attn_period": 4, "n_experts": 4, "top_k": 2},
                   {"n_experts": 4, "top_k": 2}, {"frontend": "audio_frames"}):
        Model(dataclasses.replace(cfg, **change), device="cpu")
    with pytest.raises(ValueError):
        Model(cfg, impl="pallas", device="cpu")
    with pytest.raises(ValueError):
        Model(cfg, moe_impl="sorted", device="cpu")
    with pytest.raises(ModuleNotFoundError):
        get_config("no_such_arch")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(cfg)


def _block_drawn_leaves(cfg) -> set:
    """(path, shape) of each leaf of ``cfg``'s parameters that ``_init``
    draws a block at a time (shapes only: ``param_shapes`` draws nothing)."""
    from repro_torch.models import modules
    from repro_torch.tree import tree_flatten_with_path

    shapes = Model(cfg, impl="reference", device="cpu").param_shapes()
    return {("/".join(map(str, p)), tuple(t.shape))
            for p, t in tree_flatten_with_path(shapes)[0] if modules.drawn_in_blocks(t.shape)}


def test_init_draws_every_other_leaf_whole():
    """Every leaf of every config at SMOKE size, and every leaf of the
    configs the card draws at full width (mixtral_8x7b cut to the 8 layers
    it runs with), is drawn whole, as before the block path; at full width
    only moonshot_v1_16b's expert stacks, which the card now draws, and the
    largest stacks of configs whose weights do not fit on it pass the
    threshold."""
    from repro_torch.configs.base import ARCH_IDS, EXTRA_IDS

    unfit = {"llama3_70b", "llama3_405b", "mixtral_8x7b", "mixtral_8x22b",
             "jamba_1_5_large"}
    for arch in sorted(set(ARCH_IDS) | set(EXTRA_IDS)):
        assert not _block_drawn_leaves(get_config(arch, smoke=True)), arch
        leaves = _block_drawn_leaves(get_config(arch))
        assert bool(leaves) == (arch in unfit | {"moonshot_v1_16b"}), (arch, leaves)
    assert _block_drawn_leaves(get_config("moonshot_v1_16b")) == {
        (f"blocks/0/moe/{w}", shape) for w, shape in (
            ("wg", (48, 64, 2048, 1408)), ("wu", (48, 64, 2048, 1408)),
            ("wo", (48, 64, 1408, 2048)))}
    assert not _block_drawn_leaves(dataclasses.replace(get_config("mixtral_8x7b"),
                                                       n_layers=8))
    # a whole draw: the f32 normal draw, scaled, rounded, as before
    cfg = get_config("moonshot_v1_16b", smoke=True)
    params = Model(cfg, impl="reference", device="cpu").init(torch.Generator().manual_seed(5))
    want = torch.randn((cfg.vocab_p, cfg.d_model), generator=torch.Generator().manual_seed(5))
    assert torch.equal(params["embed"]["w"], (want * 0.02).to(torch.bfloat16))


def test_block_draw_is_init_block_by_block(monkeypatch):
    """Past the threshold a leaf is drawn one leading-dim slice at a time,
    each as ``_init`` draws a leaf of the slice's shape at the leaf's
    scale, from the same generator stream."""
    from repro_torch.models import modules

    monkeypatch.setattr(modules, "BLOCK_DRAW_BYTES", 100)  # (3, 4, 5): 240 B; (4, 5): 80 B
    got = modules._init(torch.Generator().manual_seed(7), (3, 4, 5), dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(7)
    want = torch.stack([modules._init(gen, (4, 5), 3 ** -0.5, torch.bfloat16)
                        for _ in range(3)])
    assert modules.drawn_in_blocks((3, 4, 5)) and not modules.drawn_in_blocks((4, 5))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    whole = modules._init(torch.Generator().manual_seed(7), (4, 5), 0.5, torch.bfloat16)
    assert torch.equal(whole, (torch.randn((4, 5), generator=torch.Generator().manual_seed(7))
                               * 0.5).to(torch.bfloat16))
