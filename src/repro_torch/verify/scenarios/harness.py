"""Shared scenario-building plumbing: the trace/stamp/spec wiring every
scenario builder uses exactly once instead of hand-rolling it.

The :class:`GraphPair` result type, the verification param-spec tables, shape
helpers, the stamping pipeline, and :class:`BuildCtx`, the handle the
:class:`~repro_torch.verify.session.Session` threads through ``build_pair``
so scenarios of one plan share the *base* (single-device) trace when their
program + input shapes coincide (cache keyed on ``(arch/cfg, program tag,
shape signature)``, not on the scenario name;
``Report.cache.base_trace_cached`` surfaces a hit).

Shapes are :class:`~repro_torch.core.trace.ShapeDtype`s or fake tensors;
every flattening goes through :func:`repro_torch.tree.tree_flatten`, so the
traced inputs, the spec leaves and the base/dist input lists line up.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.core.ir import Graph
from repro_torch.core.stamp import TRACE_PERIODS, stamp_graph
from repro_torch.core.trace import (LAYER_TAG_STRIDE, ShapeDtype, trace,
                                    trace_sharded)
from repro_torch.models import Model
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import P, is_spec, param_specs
from repro_torch.tree import tree_leaves, tree_map_with_path


@dataclass
class GraphPair:
    """A traced (baseline, distributed) pair plus its relation registration."""

    base: Graph
    dist: Graph
    base_inputs: list
    dist_inputs: list
    input_facts: list
    output_specs: list
    size: int
    axis: str
    trace_s: float = 0.0
    stamp_s: float = 0.0
    stamped: bool = False
    base_cached: bool = False  # base trace served from the shared cache
    # every axis the dist program's mesh declares (empty = just ``axis``);
    # multi-axis scenarios set this so lint's ghost-axis check knows the
    # orthogonal axes are legitimate
    mesh_axes: tuple = ()


@dataclass
class BuildCtx:
    """Per-build context the Session hands to scenario builders.

    ``stamp`` toggles layer stamping; ``base_cache``/``base_key`` plug the
    session's shared base-trace store in (``None`` -> always trace)."""

    stamp: bool = True
    base_cache: Optional[dict] = None
    base_key: tuple = ()
    base_cached: bool = field(default=False, init=False)

    def trace_base(self, tag: str, fn, *shapes, name: str = "base",
                   grad: bool = False):
        """Trace the baseline program, shared across scenarios: the cache is
        keyed on ``(base_key, tag, shape signature)`` so any two scenarios
        tracing the *same program over the same shapes* reuse one trace.
        ``grad``: the program differentiates (:func:`trace`'s gradient
        path)."""
        return self._traced(tag, lambda: trace(fn, *shapes, name=name, grad=grad),
                            shapes)

    def trace_base_sharded(self, tag: str, fn, size: int, in_specs, *shapes,
                           axis: str = "model", name: str = "dist",
                           grad: bool = False):
        """Sharded-trace variant of :meth:`trace_base`: ``size`` ranks over
        ``axis``, or a mesh ``{axis: size}`` (:func:`trace_sharded`).  The
        composite scenario's *baseline* is exactly tp-forward's distributed
        trace, so with matching shapes they share one.  ``tag`` must
        identify program + mesh + specs (the shape signature covers only
        shapes)."""
        return self._traced(
            tag, lambda: trace_sharded(fn, size, in_specs, *shapes, axis=axis,
                                       name=name, grad=grad),
            shapes)

    def _traced(self, tag: str, thunk, shapes):
        if self.base_cache is None:
            g, in_ids, _ = thunk()
            return g, in_ids
        sig = (self.base_key, tag, _shape_sig(shapes))
        hit = self.base_cache.get(sig)
        if hit is not None:
            self.base_cached = True
            return hit
        g, in_ids, _ = thunk()
        self.base_cache[sig] = (g, in_ids)
        return g, in_ids


def _shape_sig(shapes) -> tuple:
    return tuple((tuple(a.shape), str(a.dtype)) for a in tree_leaves(shapes))


# ------------------------------------------------------------- param specs
def _expert_stack(path) -> bool:
    names = [str(p) for p in path]
    return len(names) >= 2 and names[-2] == "moe" and names[-1] in ("wg", "wu", "wo")


def verify_pspecs(param_shapes):
    """Param specs for the TP verification formulation: like execution
    specs, but MoE experts use FFN-width TP instead of expert parallelism."""

    def fix(path, spec):
        if not _expert_stack(path):
            return spec
        if str(path[-1]) == "wo":
            return P(None, None, "model", None)  # (nb, E, F, D): shard F
        return P(None, None, None, "model")  # (nb, E, D, F): shard F

    return tree_map_with_path(fix, param_specs(param_shapes), is_leaf=is_spec)


def ep_pspecs(param_shapes, axis: str):
    """Param specs for the EP verification formulation: MoE expert weights
    sharded over the *expert* dim (the execution sharding), everything else
    replicated: the scenario verifies the expert axis in isolation."""

    def fix(path, leaf):
        if _expert_stack(path):
            return P(None, axis, None, None)  # (nb, E, D|F, F|D): shard E
        return P(*([None] * len(leaf.shape)))

    return tree_map_with_path(fix, param_shapes)


# ------------------------------------------------------------ shape helpers
def round_layers(cfg, n_layers: Optional[int], stages: int = 1):
    """Round a layer-count override up to whole block periods (hybrids
    repeat every P layers) and, for pipeline plans, to equal stages."""
    if n_layers is None and stages <= 1:
        return cfg
    per = cfg.block_period
    n_layers = cfg.n_layers if n_layers is None else n_layers
    step = per * stages
    n_layers = max(step, (n_layers + step - 1) // step * step)
    return dataclasses.replace(cfg, n_layers=n_layers)


def batch_avals(cfg, batch: int, seq: int):
    """Batch input shapes for a forward trace (modality-aware).  Returns
    (b, seq): a vision frontend grows seq to hold its prefix and 32 tokens
    at least."""
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if cfg.frontend == "vision_patches":
        seq = max(seq, cfg.frontend_len + 32)
        return {"vision_embeds": ShapeDtype((batch, cfg.frontend_len, cfg.frontend_dim), dt),
                "tokens": ShapeDtype((batch, seq - cfg.frontend_len), torch.int64)}, seq
    if cfg.frontend == "audio_frames":
        return {"frames": ShapeDtype((batch, seq, cfg.d_model), dt)}, seq
    return {"tokens": ShapeDtype((batch, seq), torch.int64)}, seq


def model_pair(cfg, ctx: ParallelCtx, moe_impl: str = "dense"):
    """The (baseline, distributed) Model pair + shared parameter shapes.
    Both run the reference path on the CPU: traces see ``chunked_attention``,
    as the JAX traces see the jnp path, and a static MoE formulation
    (``moe_impl``; the capacity dispatch is data-dependent and never
    traced).  The distributed model's context is a template: each trace
    gets it with its own traced rank."""
    model_s = Model(cfg, ParallelCtx.single(), impl="reference", moe_impl=moe_impl,
                    device="cpu")
    model_d = Model(cfg, ctx, impl="reference", moe_impl=moe_impl, device="cpu")
    return model_s, model_d, model_s.param_shapes()


def cache_shapes(model: Model, batch: int, max_len: int):
    """The serving caches as fake tensors (shapes and dtypes, no storage):
    ``init_cache`` under a ``FakeTensorMode``, the counterpart of
    ``jax.eval_shape(lambda: model.init_cache(batch, max_len))``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return model.init_cache(batch, max_len)


# ----------------------------------------------------------------- stamping
def stamped_parts(cfg, pair_fn, periods_per_block: int):
    """Trace only TRACE_PERIODS block periods and stamp the rest, or None.

    ``periods_per_block``: layer tags per period region (block_period for
    forward traces whose periods span P layer scopes; 1 for decode traces
    whose period is one outer block scope).  Returns ``(parts, stamp_s)``."""
    total = cfg.n_layers // cfg.block_period
    if total <= TRACE_PERIODS:
        return None, 0.0
    cfg_t = dataclasses.replace(
        cfg, n_layers=TRACE_PERIODS * cfg.block_period)
    gb, b_in, gd, d_in, flat_specs = pair_fn(cfg_t)
    t0 = time.perf_counter()
    stride = LAYER_TAG_STRIDE * periods_per_block
    sb = stamp_graph(gb, total, lambda t: t // stride)
    if sb is None:
        return None, time.perf_counter() - t0
    sd = stamp_graph(gd, total, lambda t: t // stride)
    if sd is None:
        return None, time.perf_counter() - t0
    return (sb, b_in, sd, d_in, flat_specs), time.perf_counter() - t0


def stamped_or_full(cfg, pair_fn, periods_per_block: int, stamp: bool):
    """The standard stamped-with-fallback build: returns
    ``(parts, trace_s, stamp_s, stamped)``."""
    t0 = time.perf_counter()
    parts, stamp_s = (stamped_parts(cfg, pair_fn, periods_per_block)
                      if stamp else (None, 0.0))
    stamped = parts is not None
    if parts is None:
        parts = pair_fn(cfg)
    trace_s = time.perf_counter() - t0 - stamp_s
    return parts, trace_s, stamp_s, stamped


def flat_spec_leaves(specs) -> list:
    return tree_leaves(specs, is_leaf=is_spec)


__all__ = [
    "BuildCtx", "GraphPair", "batch_avals", "cache_shapes", "ep_pspecs",
    "flat_spec_leaves", "model_pair", "round_layers", "stamped_or_full",
    "stamped_parts", "verify_pspecs",
]
