"""Model: config-driven decoder/encoder stacks (dense, SSM, hybrid and MoE
families, and the audio-frame and vision-patch frontends).

Layers are stored **stacked by block position**, as in the JAX package:
``params["blocks"][j]`` holds the parameters of layers ``j, j+P, j+2P, ...``
(P = cfg.block_period) with a leading ``n_blocks`` dim.  The forward pass is
a Python loop over layers.

Each layer mixes with attention or with an SSD block, as
``cfg.is_attn_layer`` says for its block position.  ``impl="kernel"`` (the
default) runs prefill/forward attention through the flash-attention kernel
and the SSD scan through its kernel, the counterpart of the JAX
``impl="pallas"``; ``impl="reference"`` keeps ``chunked_attention`` and
``ssd_chunked``.  Decode bypasses both kernels (``chunked_attention`` and
the O(1) ``ssm_decode`` recurrence).  The kernels have no backward and
refuse a tensor that autograd tracks (``kernels/ops.py``), so ``loss`` is
differentiated on ``impl="reference"``.

MoE layers run ``MOE_IMPLS[moe_impl]``: the capacity dispatch
(``"capacity"``, the default, what prefill, decode and TP execution run) or
one of the verifier's static formulations (``"dense"`` for TP, ``"ep"`` for
expert parallelism), as in the JAX package.  The capacity dispatch of
prefill/forward takes ``impl`` too: ``"kernel"`` moves its rows with the
dispatch's gather and combine kernels; decode keeps the reference's.

Granite's multipliers (``cfg.embedding_multiplier``,
``cfg.residual_multiplier``, ``cfg.logits_scaling``) scale the token
embeddings, each mixer and MLP/MoE branch before its residual add, and
divide the head's logits, on every path (forward, decode, loss); at 1.0
each is left out, so the other configs run as before.

The frontends are stubs, as in the JAX package: the model's inputs are
precomputed frame embeddings (``frames``, the whole sequence) or patch
embeddings (``vision_embeds``, projected by ``vis_proj`` into a prefix of
the token embeddings).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel.collectives import vp_embed, vp_embed_sp
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.scope import counted, named_scope, span, traced_recompute, trips
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

from .attention import attn_decode, attn_fwd, attn_init, attn_init_cache, write_index
from .mlp import mlp_fwd, mlp_init, moe_dense_fwd, moe_ep_fwd, moe_fwd, moe_init
from .modules import (_init, dynamic_slice_in_dim, linear, linear_init, rmsnorm,
                      rmsnorm_init, take)
from .ssm import ssm_decode, ssm_fwd, ssm_init, ssm_init_cache

IMPLS = ("kernel", "reference")
# moe_impl -> forward implementation: "capacity" is the execution dispatch,
# "dense" the TP verification formulation, "ep" the expert-parallel
# verification formulation (unrolled expert slice/add loop)
MOE_IMPLS = {"capacity": moe_fwd, "dense": moe_dense_fwd, "ep": moe_ep_fwd}


def resolve_device(device) -> torch.device:
    """The device to run on; raises for CUDA when no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def _tree_index(tree, i: int):
    return tree_map(lambda a: a[i], tree)


class Model:
    def __init__(self, cfg: ArchConfig, ctx: ParallelCtx = ParallelCtx.single(),
                 impl: str = "kernel", moe_impl: str = "capacity", device="cuda",
                 weight_gather=None):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be one of {tuple(MOE_IMPLS)}, "
                             f"got {moe_impl!r}")
        self.cfg = cfg
        self.ctx = ctx
        self.impl = impl
        self.moe_impl = moe_impl
        # weight_gather: a tuple over block positions of trees of gather dims
        # (-1 = resident).  Weights sharded over (model x data) are gathered
        # over the data axis a block at a time in the decode step, which
        # bounds resident weight memory to 1/(tp*dp) plus one gathered block
        # (serving a giant model), as in the JAX package.
        self.weight_gather = weight_gather
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def _maybe_gather_block(self, bparams_j, j: int):
        """Block position ``j``'s parameters with each leaf that
        ``weight_gather`` names gathered over ``"data"`` along its dim."""
        if self.weight_gather is None:
            return bparams_j
        leaves, treedef = tree_flatten(bparams_j)
        dims = tree_flatten(self.weight_gather[j])[0]
        return tree_unflatten(treedef, [
            a if dim is None or dim < 0 else self.ctx.all_gather(a, "data", dim)
            for a, dim in zip(leaves, dims)])

    # ------------------------------------------------------------------ params
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn from ``generator``, which must live on the
        model's device."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        cfg, dt = self.cfg, self.dtype
        P = cfg.block_period
        nb = cfg.n_layers // P
        params: dict[str, Any] = {
            # standard small embedding init (0.02), as in the JAX package
            "embed": {"w": _init(generator, (cfg.vocab_p, cfg.d_model), 0.02, dt)},
            "ln_f": rmsnorm_init(generator, cfg.d_model, dt),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = linear_init(generator, cfg.d_model, cfg.vocab_p, dtype=dt)
        if cfg.frontend == "vision_patches":
            params["vis_proj"] = linear_init(generator, cfg.frontend_dim, cfg.d_model,
                                             bias=True, dtype=dt)
        blocks = []
        for j in range(P):
            blk = {"ln1": rmsnorm_init(generator, cfg.d_model, dt, (nb,))}
            if cfg.is_attn_layer(j):
                blk["attn"] = attn_init(generator, cfg, stacked=(nb,), dtype=dt)
            else:
                blk["ssm"] = ssm_init(generator, cfg, stacked=(nb,), dtype=dt)
            if cfg.is_moe_layer(j):
                blk["ln2"] = rmsnorm_init(generator, cfg.d_model, dt, (nb,))
                blk["moe"] = moe_init(generator, cfg, stacked=(nb,), dtype=dt)
            elif cfg.d_ff > 0:
                blk["ln2"] = rmsnorm_init(generator, cfg.d_model, dt, (nb,))
                blk["mlp"] = mlp_init(generator, cfg, cfg.d_ff, stacked=(nb,), dtype=dt)
            blocks.append(blk)
        params["blocks"] = tuple(blocks)
        return params

    def param_shapes(self) -> dict:
        """The parameter tree as fake tensors (shapes and dtypes, no storage):
        ``init`` run under a ``FakeTensorMode``, the counterpart of
        ``jax.eval_shape(model.init, key)``."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        gen = torch.Generator(device=self.device)
        with FakeTensorMode():
            return self.init(gen)

    # ------------------------------------------------------------------ embed/head
    def _inputs_to_hidden(self, params, batch):
        """The first hidden states: the frontend's prefix (``vis_proj`` of
        the patch embeddings, or the frames in the model's dtype) and the
        token embeddings, concatenated along the sequence.  Under SP with a
        frontend every rank holds the whole sequence and enters the SP
        region by taking its chunk (``dynamic_slice_in_dim`` at ``rank *
        chunk``), as ``lax.dynamic_slice_in_dim`` at ``axis_index * chunk``
        does in the JAX package."""
        cfg, ctx = self.cfg, self.ctx
        multi = cfg.frontend != "none"
        parts = []
        if cfg.frontend == "vision_patches":
            parts.append(linear(params["vis_proj"], batch["vision_embeds"]))
        if cfg.frontend == "audio_frames":
            parts.append(batch["frames"].to(self.dtype))
        if "tokens" in batch:
            parts.append(self._embed_tokens(params, batch["tokens"], allow_sp=not multi))
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if multi and ctx.sp and ctx.tp_axis:
            chunk = x.shape[1] // ctx.tp_size
            x = dynamic_slice_in_dim(x, ctx.tp_index() * chunk, chunk, axis=1)
        return x

    def _embed_tokens(self, params, ids, allow_sp: bool = True):
        """Single device: ``modules.take``, ``jnp.take``'s row lookup (a
        negative id counts from the end, an id out of range gives a row of
        NaN, filled inside the lookup as JAX's gather fills).  Under TP: the
        vocab-parallel lookup ``vp_embed`` in a ``vp_embed`` scope, the region
        the verifier's meta rule trusts (under SP, unless ``allow_sp`` is off,
        ``vp_embed_sp``, which scopes the partial lookup and leaves the
        sequence reduce_scatter outside)."""
        table = params["embed"]["w"]
        if self.ctx.tp_axis:
            if self.ctx.sp and allow_sp:
                x = vp_embed_sp(table, ids, self.ctx)
            else:
                with named_scope("vp_embed"):
                    x = vp_embed(table, ids, self.ctx)
        else:
            x = take(table, ids)
        m = self.cfg.embedding_multiplier
        return x if m == 1.0 else x * m

    def _head(self, params, x):
        w = params["embed"]["w"].T if self.cfg.tie_embeddings else params["lm_head"]["w"]
        logits = x @ w
        s = self.cfg.logits_scaling
        return logits if s == 1.0 else logits / s

    def _branch(self, y):
        """A mixer's or MLP/MoE's output as its residual add takes it."""
        r = self.cfg.residual_multiplier
        return y if r == 1.0 else y * r

    # ------------------------------------------------------------------ layers
    def _layer_fwd(self, lparams, x, positions, j: int, kv_out: Optional[list] = None):
        cfg, ctx = self.cfg, self.ctx
        h = ctx.sp_exit(x)
        hn = rmsnorm(lparams["ln1"], h, cfg.norm_eps)
        if cfg.is_attn_layer(j):
            x = x + self._branch(attn_fwd(cfg, ctx, lparams["attn"], hn, positions,
                                          impl=self.impl, kv_out=kv_out))
        else:
            x = x + self._branch(ssm_fwd(cfg, ctx, lparams["ssm"], hn, impl=self.impl))
        if "ln2" in lparams:
            h = ctx.sp_exit(x)
            hn = rmsnorm(lparams["ln2"], h, cfg.norm_eps)
            if cfg.is_moe_layer(j) and self.moe_impl == "capacity":
                x = x + self._branch(moe_fwd(cfg, ctx, lparams["moe"], hn, impl=self.impl))
            elif cfg.is_moe_layer(j):
                x = x + self._branch(MOE_IMPLS[self.moe_impl](cfg, ctx, lparams["moe"], hn))
            else:
                with span("mlp"):
                    x = x + self._branch(mlp_fwd(cfg, ctx, lparams["mlp"], hn))
        return x

    def _block(self, params, x, positions, i: int, kv_out: Optional[list] = None):
        """Block ``i``: layers ``i*P .. i*P+P-1`` (P the block period), each
        in its ``layer<li>`` scope.  In count mode (the dry run) one block
        stands for every block, a checkpoint's recomputation included."""
        P = self.cfg.block_period
        with counted(self.cfg.n_layers // P, "layer"):
            for j in range(P):
                with named_scope(f"layer{i * P + j}"):
                    x = self._layer_fwd(_tree_index(params["blocks"][j], i), x, positions,
                                        j, kv_out)
        return x

    def forward(self, params, batch, *, unroll: bool = False, remat: bool = False,
                kv_out: Optional[list] = None):
        """Full forward -> logits (B, S, V_loc[, sharded over tp]).  Each layer
        runs in a ``layer<i>`` scope (per-layer memoization in the verifier).
        ``remat`` recomputes each block period in the backward pass
        (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``
        around the JAX package's scanned block).  ``kv_out``: a list each
        attention layer's K and V, after RoPE, are appended to in layer
        order (a prefill that fills a KV cache).  ``unroll`` is accepted for
        the JAX signature; layers are always a Python loop.  Inside
        ``scope.spans()`` the forward, its embedding and head, and each
        layer's parts open their run-time spans (``scope.SPANS``)."""
        del unroll
        cfg, ctx = self.cfg, self.ctx
        with span("model.forward"):
            with span("model.embed"):
                x = self._inputs_to_hidden(params, batch)
            S = x.shape[1] * (ctx.tp_size if ctx.sp else 1)
            positions = torch.arange(S, device=x.device)
            for i in range(trips(cfg.n_layers // cfg.block_period, "layer")):
                if remat:
                    x = torch.utils.checkpoint.checkpoint(traced_recompute(self._block),
                                                          params, x, positions, i, kv_out,
                                                          use_reentrant=False)
                else:
                    x = self._block(params, x, positions, i, kv_out)
            x = ctx.sp_exit(x)
            with span("model.head"):
                x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
                return self._head(params, x)

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch, *, remat: bool = False):
        """Vocab-parallel cross entropy over f32 logits (never gathers them):
        a padded vocab's columns masked to -1e30, the stability shift ``m``
        taken of a detached copy before its ``pmax`` (any shift gives the
        same value, and the max has no gradient, as in JAX), the
        log-sum-exp and the label logit each summed over the model axis,
        and the mean NLL.  The vocab offset is the rank tensor's."""
        cfg, ctx = self.cfg, self.ctx
        lf = self.forward(params, batch, remat=remat).float()
        V_loc = lf.shape[-1]
        gidx = ctx.tp_index() * V_loc + torch.arange(V_loc, device=lf.device)
        if cfg.vocab_p != cfg.vocab:
            lf = torch.where(gidx >= cfg.vocab, -1e30, lf)
        m = ctx.pmax_tp(lf.detach().amax(dim=-1))
        lse = torch.log(ctx.psum_tp(torch.exp(lf - m[..., None]).sum(-1))) + m
        tgt = batch["labels"][..., None] == gidx
        label_logit = ctx.psum_tp(torch.where(tgt, lf, 0.0).sum(-1))
        return (lse - label_logit).mean()

    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Prefill: the full forward.  As in the JAX package it returns the
        logits only; the serving engine fills its caches through
        ``decode_step``."""
        del max_len
        return self.forward(params, batch)

    # ------------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_len: int) -> tuple:
        """Stacked per-block-position caches (KV for attention layers, SSD
        state and conv buffers for SSM layers), zeroed, on the model's
        device; under context parallelism each KV cache holds the rank's
        ``max_len // cp_size`` positions."""
        cfg, ctx = self.cfg, self.ctx
        P = cfg.block_period
        nb = cfg.n_layers // P
        s_loc = max_len // ctx.cp_size if ctx.cp_axis else max_len
        caches = []
        for j in range(P):
            if cfg.is_attn_layer(j):
                c = attn_init_cache(cfg, batch, s_loc, self.ctx.tp_size,
                                    dtype=self.dtype, device=self.device)
            else:
                c = ssm_init_cache(cfg, batch, self.ctx.tp_size, dtype=self.dtype,
                                   device=self.device)
            caches.append({k: v.new_zeros((nb, *v.shape)) for k, v in c.items()})
        return tuple(caches)

    def cache_specs(self, batch: int, max_len: int) -> tuple:
        """The caches as fake tensors (shapes and dtypes, no storage):
        ``init_cache`` under a ``FakeTensorMode``, the counterpart of
        ``jax.eval_shape(lambda: self.init_cache(batch, max_len))``."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            return self.init_cache(batch, max_len)

    def decode_step(self, params, token, caches, position, *, unroll: bool = False):
        """One decode step.  token: (B,) int; position: a 0-d int64 tensor
        on the model's device (a Python int is converted).  Returns (logits
        (B, V_loc), caches): the caches are written in place and returned
        (the JAX version returns updated copies; the verifier traces this
        step functionalized, so the written caches are its outputs).  Block
        ``i`` runs in a ``layer<i>`` scope and its sub-layer ``j`` in
        ``sub<j>``, one stamping period per block."""
        del unroll
        cfg = self.cfg
        position = torch.as_tensor(position, dtype=torch.int64, device=self.device)
        x = self._embed_tokens(params, token[:, None])  # (B,1,D)
        P = cfg.block_period
        kv = next((c["k"] for c in caches if "k" in c), None)
        # the KV write index, once for every layer
        w = None if kv is None else write_index(position, kv.shape[3])[None]
        nb = cfg.n_layers // P
        for i in range(trips(nb, "layer")):
            with counted(nb, "layer"), named_scope(f"layer{i}"):  # the block's slices
                lps = [self._maybe_gather_block(_tree_index(params["blocks"][j], i), j)
                       for j in range(P)]
                # views into the stacked caches
                cs = [_tree_index(caches[j], i) for j in range(P)]
                for j in range(P):
                    with named_scope(f"sub{j}"):
                        x = self._decode_layer(lps[j], cs[j], position, w, x, j)
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = self._head(params, x)[:, 0]  # (B, V)
        return logits, caches

    def _decode_layer(self, lp, cache, position, write_at, x, j: int):
        cfg, ctx = self.cfg, self.ctx
        hn = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if cfg.is_attn_layer(j):  # writes its KV cache in place
            mix, _ = attn_decode(cfg, ctx, lp["attn"], hn, cache, position, write_at)
        else:  # returns new tensors: copy them into the views
            mix, new = ssm_decode(cfg, ctx, lp["ssm"], hn, cache)
            for name, t in new.items():
                cache[name].copy_(t)
        x = x + self._branch(mix)
        if "ln2" in lp:
            hn = rmsnorm(lp["ln2"], x, cfg.norm_eps)
            if cfg.is_moe_layer(j):
                x = x + self._branch(MOE_IMPLS[self.moe_impl](cfg, ctx, lp["moe"], hn))
            else:
                x = x + self._branch(mlp_fwd(cfg, ctx, lp["mlp"], hn, decode=True))
        return x
