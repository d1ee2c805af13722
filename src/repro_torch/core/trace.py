"""make_fx -> TensorIR extraction (the paper's "IR graph generation" stage).

``make_fx(tracing_mode="fake")`` gives the ATen-level program of a torch
function over fake tensors: no storage is allocated, so full-width models
trace on a laptop.  This module lowers that graph into the op vocabulary of
:mod:`repro_torch.core.ir` (the vocabulary the JAX package's tracer emits)
so the same rules verify both:

* ATen ops with a 1:1 counterpart are renamed (``mm``/``bmm`` -> ``dot``,
  ``view`` -> ``reshape``, ``unsqueeze`` -> ``broadcast`` (jnp's
  ``expand_dims``), ``permute`` -> ``transpose``, ``expand`` ->
  ``broadcast``, ``_to_copy`` -> ``convert``, ``cat`` -> ``concat``,
  ``index`` -> ``gather``, ...);
* composite ops are decomposed the way ``jax.numpy`` lowers them
  (``mean`` -> ``reduce_sum`` + ``div``, ``silu`` -> ``logistic`` + ``mul``,
  ``clamp`` -> ``max`` + ``min``, ``_softmax`` (its max floored at -inf
  and a ``stop_gradient`` ``copy``), ``addmm``, ``triu``/``tril``,
  ``softplus``, tanh-approximate ``gelu``, ``constant_pad_nd``), with jnp's
  explicit rank-promoting broadcasts and ``where`` as ``select(pred,
  on_false, on_true)``; ATen's spellings of one jnp op are folded back
  (``einsum`` and a matmul by a matrix as ``dot_general``s, ``c / x``,
  chains of ``unsqueeze``);
* the program is traced functionalized: in-place writes to its inputs
  (a serving step's caches) become outputs;
* a program that differentiates with ``torch.autograd`` (``grad=True``) is
  traced as it runs, without functionalize: ``repro_torch::dot_general``
  differentiates by ``lax.dot_general``'s transpose rules (its cotangents
  are ``dot_general``s), the backward pass's in-place ops take their
  functional forms, each backward op takes the source and scope of the
  forward call whose autograd node it runs in, and ATen's
  backward ops lower as JAX transposes their forward ops
  (``select_backward``/``slice_backward`` as a zero ``pad``,
  ``silu_backward``, ``gelu_backward`` and ``softplus_backward`` as the
  transposed JVP chains, a row lookup's ``index_put`` as ``scatter_add``,
  ``flip(cumsum(flip))`` as a reverse ``cumsum``);
* Python scalars become hash-consed ``const`` leaves; scalar int
  arithmetic on constants folds at trace time;
* the functional collectives become ``all_reduce``/``all_gather``/
  ``reduce_scatter`` nodes over the axis of the group each runs on
  (``wait_tensor`` is dropped), and each of the context's rank inputs is
  emitted as ``axis_index`` over its axis;
  ``repro_torch::dynamic_slice`` (``modules.dynamic_slice_in_dim``, a slice
  at a tensor start such as ``rank * chunk``) becomes
  ``lax.dynamic_slice_in_dim``'s start wrap and ``dynamic_slice``;
* the MoE router's ops trace as their jnp forms: ``repro_torch::top_k``
  (``mlp.top_k``) as ``lax.top_k``'s two ``top_k`` nodes, ``repeat`` of a
  unit dim as ``jnp.repeat``, and ``index_put`` with ``accumulate`` as
  ``.at[i, j].add`` (index wraps, unit dims, ``concat``, one
  ``scatter_add``);
* every node carries ``src`` (``file.py:line`` of the innermost frame
  outside torch and this module, captured by a ``TorchFunctionMode`` while
  tracing), its ``named_scope`` path (:mod:`repro_torch.scope`) and the
  layer tag derived from it.

:func:`trace_sharded` traces the per-rank program of a sharded function
under a fake process group of the axis size, or of a mesh's size with one
subgroup an axis: the counterpart of tracing the body of a ``shard_map``.  Any op outside the table is emitted
as an opaque node named after it (sound: it verifies only against a
congruent opaque node).
"""
from __future__ import annotations

import hashlib
import itertools
import math
import operator
import os
import re
import sys
from contextlib import contextmanager
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.fx.traceback as fx_traceback
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import ShapeDtype
from repro_torch.models.modules import einsum_f32, silu
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

from .ir import Graph

_LAYER_RE = re.compile(r"(?:^|/)layer[_]?(\d+)")
_SUB_RE = re.compile(r"(?:^|/)sub(\d+)")

# tag stride between consecutive ``layer<i>`` scopes: room for per-layer
# sub-scopes (decode blocks) without colliding with the next layer's tag
LAYER_TAG_STRIDE = 4096


def default_layer_tag(scope: str) -> Optional[int]:
    m = _LAYER_RE.search(scope)
    if m is None:
        return None
    tag = int(m.group(1)) * LAYER_TAG_STRIDE
    ms = _SUB_RE.search(scope)
    if ms is not None:  # block-level scope with per-layer sub-scopes (decode)
        tag += int(ms.group(1)) + 1
    return tag


DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32", torch.bfloat16: "bfloat16",
    torch.float16: "float16", torch.int64: "int64", torch.int32: "int32",
    torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32,
              torch.bfloat16: np.float32, torch.float16: np.float16,
              torch.int64: np.int64, torch.int32: np.int32, torch.int16: np.int16,
              torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_}


_DTYPES_BY_NAME = {v: k for k, v in DTYPE_NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    return DTYPE_NAMES.get(dtype) or str(dtype).removeprefix("torch.")


def _const_hash(arr: np.ndarray) -> str:
    return hashlib.sha1(
        arr.tobytes() + str(arr.shape).encode() + str(arr.dtype).encode()
    ).hexdigest()[:16]


# --------------------------------------------------------------------------
# source locations: the innermost frame outside torch, the standard library
# and the tracing plumbing

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_STDLIB_DIR = os.path.dirname(os.path.abspath(os.__file__))
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PLUMBING = {os.path.abspath(__file__), os.path.join(_PKG_DIR, "tree.py"),
             os.path.join(_PKG_DIR, "scope.py")}



def _user_src(frame) -> str:
    while frame is not None:
        f = frame.f_code.co_filename
        if not (f.startswith((_TORCH_DIR, _STDLIB_DIR, "<")) or f in _PLUMBING
                or frame.f_code in (einsum_f32.__code__, silu.__code__)):  # caller's line
            outer = _marked_caller(frame)
            if outer is None:
                return f"{f.rsplit('/', 1)[-1]}:{frame.f_lineno}"
            frame = outer
            continue
        frame = frame.f_back
    return ""


def _marked_caller(frame):
    """The caller of a function marked to report its caller's line
    (``parallel.ctx.CALLER_LINE_CODES``) that ``frame`` runs inside, within
    ``frame``'s file, or None."""
    from repro_torch.parallel.ctx import CALLER_LINE_CODES

    f = frame.f_code.co_filename
    while frame is not None and frame.f_code.co_filename == f:
        if frame.f_code in CALLER_LINE_CODES:
            return frame.f_back
        frame = frame.f_back
    return None


# functionalize cannot take ATen's in-place operator ops (``__iand__``'s
# schema returns an alias of ``self``); the named in-place ops it can
_INPLACE_OPERATORS = {
    getattr(torch.Tensor, f"__i{op}__"): getattr(torch.Tensor, named)
    for op, named in (("and", "bitwise_and_"), ("or", "bitwise_or_"),
                      ("xor", "bitwise_xor_"), ("lshift", "bitwise_left_shift_"),
                      ("rshift", "bitwise_right_shift_"))}


_MATMUL = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


class _SourceMode(TorchFunctionMode):
    """Puts the caller's ``file.py:line`` on every fx node a torch call
    creates (as the node's ``stack_trace``, which fx copies under
    ``preserve_node_meta()``), records the model's ``silu`` (which rounds
    as the reference does) as ``F.silu``, and lowers ``torch.einsum`` as
    ``jnp.einsum`` does: ATen would lower it to permutes, views and a
    ``bmm`` over merged batch dims, where ``jnp.einsum`` gives one
    ``dot_general`` per pair of operands (a sharded head dim merged with
    the batch dim is no split/merge layout)."""

    def __init__(self, grad: bool = False):
        super().__init__()
        self.grad = grad
        self._hooked: set = set()
        self._saved_meta: Optional[dict] = None  # set while a backward pass runs

    def __torch_function__(self, func, types, args=(), kwargs=None):
        func = _INPLACE_OPERATORS.get(func, func)
        if self._saved_meta is not None:  # a backward op keeps its forward op's meta
            return self._call(func, args, kwargs)
        src = [_user_src(sys._getframe(1))]
        fx_traceback.set_stack_trace(src)
        out = self._call(func, args, kwargs)
        if self.grad:
            self._hook_backward(out, src)
        return out

    def _call(self, func, args, kwargs):
        if func is silu:  # the model's jax.nn.silu: logistic and mul
            return torch.nn.functional.silu(*args)
        if func in (torch.einsum, einsum_f32) and not kwargs:
            out = _einsum_as_dot_general(*args, f32=func is einsum_f32)
            if out is not None:
                return out
        if func in _MATMUL and not kwargs and args[0].ndim > 2 and args[1].ndim == 2:
            # jnp.matmul: one dot_general over the last dim, where ATen
            # folds the leading dims into rows (reshape, mm, reshape)
            return _dot_general(args[0], args[1], [args[0].ndim - 1], [0], [], [], False)
        return func(*args, **(kwargs or {}))

    # -- the backward pass: each autograd node's ops take its forward op's meta
    def _hook_backward(self, out, src: list) -> None:
        """A pre-hook on each autograd node that the call just made (those
        behind ``out`` not hooked yet): the fx nodes its backward creates
        (and the accumulation of what it returns) take the call's
        ``file:line`` and scope, as AOTAutograd's stack-trace preservation
        hooks carry the forward's traceback."""
        custom = fx_traceback.current_meta.get("custom")
        meta = (src, dict(custom) if custom is not None else None)
        todo = [t.grad_fn for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        while todo:
            fn = todo.pop()
            if fn is None or fn in self._hooked:
                continue
            self._hooked.add(fn)
            fn.register_prehook(self._prehook(meta))
            todo.extend(f for f, _ in fn.next_functions)

    def _prehook(self, meta: tuple):
        src, custom = meta

        def hook(grad_outputs):
            current = fx_traceback.current_meta
            if self._saved_meta is None:  # the first node of a backward pass
                self._saved_meta = {k: current[k] for k in _BACKWARD_META if k in current}
                torch.autograd.Variable._execution_engine.queue_callback(
                    self._end_backward)
            fx_traceback.set_stack_trace(src)
            if custom is None:
                current.pop("custom", None)
            else:
                current["custom"] = dict(custom)
        return hook

    def _end_backward(self) -> None:
        current = fx_traceback.current_meta
        for k in _BACKWARD_META:
            current.pop(k, None)
        current.update(self._saved_meta)
        self._saved_meta = None


# the fx meta a backward pass sets on the nodes it creates
_BACKWARD_META = ("stack_trace", "custom")


@torch.library.custom_op("repro_torch::dot_general", mutates_args=())
def _dot_general(lhs: torch.Tensor, rhs: torch.Tensor, lhs_contract: list[int],
                 rhs_contract: list[int], lhs_batch: list[int],
                 rhs_batch: list[int], f32: bool) -> torch.Tensor:
    """``lax.dot_general``: output dims are the batch dims, then the free
    dims of ``lhs``, then those of ``rhs``; ``f32``: accumulated and
    returned in float32 (``preferred_element_type``)."""
    if f32:
        lhs, rhs = lhs.float(), rhs.float()
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    lhs_l = [next(letters) for _ in range(lhs.ndim)]
    rhs_l = [next(letters) for _ in range(rhs.ndim)]
    for i, j in zip(lhs_contract + lhs_batch, rhs_contract + rhs_batch):
        rhs_l[j] = lhs_l[i]
    out = ([lhs_l[i] for i in lhs_batch]
           + [c for i, c in enumerate(lhs_l) if i not in lhs_contract + lhs_batch]
           + [c for j, c in enumerate(rhs_l) if j not in rhs_contract + rhs_batch])
    eq = f"{''.join(lhs_l)},{''.join(rhs_l)}->{''.join(out)}"
    return torch.einsum(eq, lhs, rhs)


@_dot_general.register_fake
def _dot_general_fake(lhs, rhs, lhs_contract, rhs_contract, lhs_batch, rhs_batch, f32):
    shape = ([lhs.shape[i] for i in lhs_batch]
             + [s for i, s in enumerate(lhs.shape) if i not in lhs_contract + lhs_batch]
             + [s for j, s in enumerate(rhs.shape) if j not in rhs_contract + rhs_batch])
    return lhs.new_empty(shape, dtype=torch.float32 if f32
                         else torch.promote_types(lhs.dtype, rhs.dtype))


def _dot_general_transpose(g, x, y, x_contract, y_contract, x_batch, y_batch, f32,
                           swap: bool):
    """The cotangent of ``x`` in ``dot_general(x, y)`` (of ``y`` with
    ``swap``, the operands and their dimension numbers exchanged), as
    ``lax._dot_general_transpose_lhs`` forms it: one ``dot_general`` of
    ``g`` with ``y``, a ``transpose`` back to ``x``'s dim order and a
    ``convert`` to ``x``'s dtype where they differ."""
    skip = set(x_contract) | set(x_batch)
    x_kept = [i for i in range(x.ndim) if i not in skip]
    skip = set(y_contract) | set(y_batch)
    y_kept = [i for i in range(y.ndim) if i not in skip]
    nb = len(x_batch)
    start = nb if swap else nb + len(x_kept)
    ans_y = list(range(start, start + len(y_kept)))
    by_y = [x_contract[i] for i in sorted(range(len(y_contract)), key=y_contract.__getitem__)]
    unsorted = list(x_batch) + x_kept + by_y
    out = _dot_general(g, y, ans_y, y_kept, list(range(nb)), list(y_batch), f32)
    out = out.permute(sorted(range(len(unsorted)), key=unsorted.__getitem__))
    return out if out.dtype == x.dtype else out.to(x.dtype)


def _dot_general_setup(ctx, inputs, output):
    lhs, rhs, *dims = inputs
    ctx.save_for_backward(lhs, rhs)
    ctx.dims = dims


def _dot_general_backward(ctx, g):
    """``lax.dot_general``'s transpose rules: both cotangents are
    ``dot_general``s, so a traced backward's products are ``dot`` nodes
    as JAX's are."""
    lhs, rhs = ctx.saved_tensors
    lc, rc, lb, rb, f32 = ctx.dims
    gl = gr = None
    if ctx.needs_input_grad[0]:
        gl = _dot_general_transpose(g, lhs, rhs, lc, rc, lb, rb, f32, swap=False)
    if ctx.needs_input_grad[1]:
        gr = _dot_general_transpose(g, rhs, lhs, rc, lc, rb, lb, f32, swap=True)
    return gl, gr, None, None, None, None, None


_dot_general.register_autograd(_dot_general_backward, setup_context=_dot_general_setup)


def _einsum_path(inputs: list[str], output: str, sizes: dict) -> list[tuple]:
    """The pairwise contraction order ``jnp.einsum`` takes by default:
    opt_einsum's ``optimal`` search (its choice for up to four operands),
    with opt_einsum's flop count, tie-breaking and pair-cost cache (keyed
    on the two operands alone, so a pair costed once is not re-costed when
    other operands have gone), in linear form."""
    if len(inputs) <= 2:
        return [tuple(range(len(inputs)))]
    out = frozenset(output)
    best = {"flops": float("inf"), "ssa": (tuple(range(len(inputs))),)}
    cache: dict = {}

    def search(path, remaining, ins, cost):
        if len(remaining) == 1:
            best["flops"], best["ssa"] = cost, path
            return
        for i, j in itertools.combinations(remaining, 2):
            i, j = min(i, j), max(i, j)
            key = (ins[i], ins[j])
            if key not in cache:
                keep = frozenset.union(out, *(ins[r] for r in remaining - {i, j}))
                either = ins[i] | ins[j]
                inner = bool((ins[i] & ins[j]) - keep)
                cache[key] = (either & keep,
                              int(np.prod([sizes[c] for c in either])) * (2 if inner else 1))
            k12, flops = cache[key]
            if cost + flops < best["flops"]:
                search(path + ((i, j),), remaining - {i, j} | {len(ins)}, ins + (k12,),
                       cost + flops)

    search((), set(range(len(inputs))), tuple(frozenset(t) for t in inputs), 0)
    ids, linear, ssa = list(range(len(inputs))), [], len(inputs)
    for step in best["ssa"]:
        con = sorted(ids.index(k) for k in step)
        for k in reversed(con):
            ids.pop(k)
        ids.append(ssa)
        linear.append(tuple(con))
        ssa += 1
    return linear


def _einsum_as_dot_general(equation, *operands, f32: bool = False):
    """``torch.einsum`` without ellipsis or repeated letters, lowered as
    ``jnp.einsum`` lowers it: pairwise contractions in opt_einsum's order,
    each a ``dot_general`` (operands swapped where that saves a transpose)
    after summing out letters unique to one side and dropping unit dims the
    other side broadcasts, then one ``transpose`` where the names are out of
    order; None for what this does not cover.  ``f32``: two operands of one
    type, ``preferred_element_type=float32``."""
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    if "..." in equation or "->" not in equation:
        return None
    ins, output = equation.replace(" ", "").split("->")
    names = ins.split(",")
    if len(names) != len(operands) or any(
            len(set(t)) != len(t) for t in names + [output]):
        return None
    sizes = {c: t.shape[i] for n, t in zip(names, operands) for i, c in enumerate(n)}
    out_dtype = _promote([t.dtype for t in operands])
    if f32:
        if len(operands) != 2 or operands[0].dtype != operands[1].dtype:
            return None
        out_dtype = torch.float32
    ops, path = list(operands), _einsum_path(names, output, sizes)
    out_set = frozenset(output)
    for step, inds in enumerate(path):
        inds = sorted(inds, reverse=True)
        picked = [names.pop(k) for k in inds]
        remain = out_set.union(*map(frozenset, names))
        contract = frozenset("".join(picked))
        kept = remain & contract
        result = (output if step == len(path) - 1
                  else "".join(sorted(kept, key="".join(picked).find)))
        removed = sorted(contract - kept)
        if len(inds) == 1:
            x, xn = _sum_out(ops.pop(inds[0]), picked[0], removed, out_dtype)
        else:
            lhs, rhs = ops.pop(inds[0]), ops.pop(inds[1])
            x, xn = _contract_pair(lhs, picked[0], rhs, picked[1], removed, result,
                                   out_dtype, f32)
        if xn != result:
            x = x.permute([xn.index(c) for c in result])
        ops.append(x)
        names.append(result)
    return ops[0].to(out_dtype)


def _sum_out(x, xn: str, letters, dtype):
    """``jnp.einsum``'s ``sum_uniques``: one ``reduce_sum`` over ``letters``."""
    axes = [xn.index(c) for c in letters if c in xn]
    if not axes:
        return x, xn
    if torch.promote_types(x.dtype, dtype) != x.dtype:
        x = x.to(dtype)
    return x.sum(axes), "".join(c for c in xn if c not in letters)


def _contract_pair(lhs, ln: str, rhs, rn: str, contracted, result: str, dtype,
                   f32: bool):
    def drop_units(x, xn, other, on):
        keep = [x.shape[i] != 1 or c not in on or other.shape[on.index(c)] == 1
                for i, c in enumerate(xn)]
        if all(keep):
            return x, xn
        return (x.reshape([s for s, k in zip(x.shape, keep) if k]),
                "".join(c for c, k in zip(xn, keep) if k))

    lhs, ln = drop_units(lhs, ln, rhs, rn)
    rhs, rn = drop_units(rhs, rn, lhs, ln)
    lhs, ln = _sum_out(lhs, ln, [c for c in contracted if c not in rn], dtype)
    rhs, rn = _sum_out(rhs, rn, [c for c in contracted if c not in ln], dtype)
    contracted = [c for c in contracted if c in ln and c in rn]
    batch = [c for c in result if c in ln and c in rn]
    lc, rc = [ln.index(c) for c in contracted], [rn.index(c) for c in contracted]
    lb, rb = [ln.index(c) for c in batch], [rn.index(c) for c in batch]
    gone = set(batch) | set(contracted)
    rest_l = "".join(c for c in ln if c not in gone)
    rest_r = "".join(c for c in rn if c not in gone)
    names = "".join(batch) + rest_r + rest_l
    if names == result:  # rhs first: no transpose needed
        return _dot_general(rhs, lhs, rc, lc, rb, lb, f32), names
    return _dot_general(lhs, rhs, lc, rc, lb, rb, f32), "".join(batch) + rest_l + rest_r


@contextmanager
def fake_process_group(size: int, mesh: Optional[dict] = None):
    """A default process group of ``size`` fake ranks (this process is rank
    0) for the duration of a trace; torn down on exit, so no default group
    is left behind.  With ``mesh`` (an ordered ``{axis: size}`` whose sizes
    multiply to ``size``) it yields a ``DeviceMesh`` over those ranks, one
    fake subgroup per axis; else None."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; trace the "
                           "per-rank program in a process without one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        if mesh is None:
            yield None
        else:
            from torch.distributed.device_mesh import init_device_mesh

            yield init_device_mesh("cpu", tuple(mesh.values()),
                                   mesh_dim_names=tuple(mesh))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# ATen -> IR

_A = torch.ops.aten
_UNARY = {
    _A.neg: "neg", _A.exp: "exp", _A.log: "log", _A.log1p: "log1p", _A.tanh: "tanh",
    _A.rsqrt: "rsqrt", _A.sqrt: "sqrt", _A.sin: "sin", _A.cos: "cos", _A.abs: "abs",
    _A.sign: "sign", _A.floor: "floor", _A.ceil: "ceil", _A.round: "round",
    _A.erf: "erf", _A.sigmoid: "logistic", _A.exp2: "exp2",
    _A.logical_not: "not", _A.bitwise_not: "not", _A.isfinite: "is_finite",
}
_BINARY = {
    _A.add: "add", _A.sub: "sub", _A.mul: "mul", _A.div: "div",
    _A.maximum: "max", _A.minimum: "min", _A.pow: "pow", _A.remainder: "rem",
    _A.fmod: "rem", _A.atan2: "atan2",
}
_COMPARE = {_A.lt: "lt", _A.le: "le", _A.gt: "gt", _A.ge: "ge", _A.eq: "eq",
            _A.ne: "ne"}
_LOGICAL = {_A.bitwise_and: "and", _A.logical_and: "and", _A.bitwise_or: "or",
            _A.logical_or: "or", _A.bitwise_xor: "xor", _A.logical_xor: "xor"}
_REDUCE = {_A.sum: "reduce_sum", _A.amax: "reduce_max", _A.amin: "reduce_min",
           _A.prod: "reduce_prod", _A.any: "reduce_or", _A.all: "reduce_and"}
_IDENTITY = {_A.clone, _A.contiguous, _A.alias, _A.detach, _A.lift_fresh,
             _A.lift_fresh_copy}
_RESHAPE = {_A.view, _A._unsafe_view, _A.reshape, _A.squeeze,
            _A.flatten, _A.unflatten}
_FILL = {_A.full: None, _A.zeros: 0, _A.ones: 1, _A.new_full: None, _A.new_zeros: 0,
         _A.new_ones: 1, _A.full_like: None, _A.zeros_like: 0, _A.ones_like: 1,
         _A.scalar_tensor: None}
_REDUCE_OPS = {"sum": "add", "max": "max", "min": "min", "product": "mul"}
_FOLD = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "max": np.maximum, "min": np.minimum, "neg": np.negative,
    "lt": np.less, "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal,
    "eq": np.equal, "ne": np.not_equal, "and": np.logical_and, "or": np.logical_or,
}


def _c10d_ops() -> dict:
    """The functional collectives' op packets -> their names."""
    ns = torch.ops._c10d_functional
    return {getattr(ns, n): n for n in ("all_reduce", "all_gather_into_tensor",
                                        "reduce_scatter_tensor", "all_to_all_single",
                                        "wait_tensor")}


class Ref(int):
    """A lowered fx value (an IR node id), told apart from a Python int
    literal among an op's arguments."""


class Tracer:
    """Lowers one fx graph into a :class:`Graph`.  Constants are hash-consed
    across the whole trace: unrolled layers re-create identical literals,
    and dedup keeps repeated layers referencing period-invariant leaves
    (required by layer stamping; sound because the e-graph merges
    equal-payload consts into one e-class anyway)."""

    def __init__(self, layer_tag_fn: Callable[[str], Optional[int]] = default_layer_tag,
                 group_axes: Optional[dict] = None):
        self.g = Graph()
        self.layer_tag_fn = layer_tag_fn
        # process-group name -> the mesh axis its collectives run over
        self.group_axes = group_axes or {}
        self._scalar_val: dict[int, Any] = {}
        self._const_cache: dict[tuple, int] = {}
        # src, scope, layer and count-mode multiplicity of the node being lowered
        self._ctx = ("", "", None, 1)
        self._c10d = _c10d_ops()
        # silu's input -> its logistic, the residual silu's backward reuses;
        # the tanh gelu's input -> its tanh and cdf; softplus' -> its value
        self._logistic: dict[int, int] = {}
        self._gelu: dict[int, tuple] = {}
        self._softplus_out: dict[int, int] = {}
        # (ids, rows) -> the wrapped index vector a take gathers with, which
        # its transpose scatters with
        self._take_index: dict[tuple, int] = {}

    # -- leaves ---------------------------------------------------------------
    def add_const(self, arr: np.ndarray, dtype: str) -> int:
        arr = np.asarray(arr)
        h = _const_hash(arr)
        key = (h, tuple(arr.shape), dtype)
        hit = self._const_cache.get(key)
        if hit is not None:
            return hit
        params: dict[str, Any] = {"value_hash": h}
        if not np.any(arr):
            # all-zero payload: rules about additive identities key on this
            params["zero"] = True
        if arr.shape == () and arr.dtype.kind in "ib":
            # scalar int/bool payload carried on the node: rank-indexed
            # slicing rules match the chunk constant in ``axis_index * chunk``
            params["value"] = int(arr)
        nid = self.g.add("const", (), arr.shape, dtype, params)
        if arr.shape == () and arr.dtype.kind in "ib":
            self._scalar_val[nid] = arr
        self._const_cache[key] = nid
        return nid

    def scalar(self, value, dtype: torch.dtype) -> int:
        return self.add_const(np.asarray(value, dtype=_NP_DTYPES.get(dtype, np.float64)),
                              dtype_name(dtype))

    def weak_scalar(self, value, dtype: torch.dtype) -> int:
        """A Python scalar as ``jnp.pad`` takes it: a weakly typed constant
        (float32, int32 or bool) and a ``convert_element_type`` to
        ``dtype``, emitted even where the types agree (the weak type
        goes)."""
        weak = (torch.bool if isinstance(value, bool)
                else torch.int32 if isinstance(value, int) else torch.float32)
        name = dtype_name(dtype)
        return self.emit("convert", [self.scalar(value, weak)], (), name,
                         {"new_dtype": name})

    # -- emission -------------------------------------------------------------
    def emit(self, op: str, inputs, shape, dtype, params: Optional[dict] = None) -> int:
        dt = dtype if isinstance(dtype, str) else dtype_name(dtype)
        fn = _FOLD.get(op)
        if (fn is not None and tuple(shape) == () and dt in ("int64", "int32", "bool")
                and inputs and all(i in self._scalar_val for i in inputs)):
            val = np.asarray(fn(*[self._scalar_val[i] for i in inputs]))
            return self.add_const(val.astype(np.bool_ if dt == "bool" else dt), dt)
        src, scope, layer, mult = self._ctx
        if mult != 1:  # traced in a counted loop (repro_torch.scope.counting)
            params = {**(params or {}), "mult": mult}
        return self.g.add(op, inputs, tuple(shape), dt, params, src=src, layer=layer,
                          scope=scope)

    def operand(self, a, dtype: torch.dtype) -> int:
        """IR id of an fx argument: a lowered node, or a Python scalar as a
        constant of ``dtype``."""
        if isinstance(a, Ref):
            return int(a)
        if isinstance(a, (bool, int, float, np.number)):
            return self.scalar(a, dtype)
        raise TypeError(f"unsupported operand {a!r}")

    def convert(self, nid: int, dtype: torch.dtype) -> int:
        n = self.g[nid]
        name = dtype_name(dtype)
        if n.dtype == name:
            return nid
        if n.op == "const" and n.shape == () and nid in self._scalar_val:
            return self.add_const(self._scalar_val[nid].astype(_NP_DTYPES[dtype]), name)
        return self.emit("convert", [nid], n.shape, name, {"new_dtype": name})

    def promote_rank(self, nid: int, rank: int) -> int:
        """jnp's implicit broadcasting: a lower-rank operand (not a scalar)
        gets leading unit dims through an explicit ``broadcast``."""
        n = self.g[nid]
        k = rank - len(n.shape)
        if k <= 0 or not n.shape:
            return nid
        shape = (1,) * k + n.shape
        return self.emit("broadcast", [nid], shape, n.dtype,
                         {"shape": shape, "broadcast_dimensions": tuple(range(k, rank))})

    def broadcast_to(self, nid: int, shape: tuple) -> int:
        """``jnp.broadcast_to``: one ``broadcast_in_dim`` to the full shape."""
        n = self.g[nid]
        if n.shape == tuple(shape):
            return nid
        k = len(shape) - len(n.shape)
        return self.emit("broadcast", [nid], shape, n.dtype,
                         {"shape": tuple(shape),
                          "broadcast_dimensions": tuple(range(k, len(shape)))})

    def reshape(self, nid: int, shape: tuple) -> int:
        n = self.g[nid]
        if n.shape == tuple(shape):
            return nid
        return self.emit("reshape", [nid], shape, n.dtype, {"new_sizes": tuple(shape)})

    def slice(self, nid: int, dim: int, start: int, stop: int, step: int = 1,
              whole: bool = False) -> int:
        """``lax.slice`` along ``dim``; a slice of the whole dim is dropped
        unless ``whole`` (``lax.index_in_dim`` emits it)."""
        n = self.g[nid]
        if start == 0 and stop == n.shape[dim] and step == 1 and not whole:
            return nid
        st = [0] * len(n.shape)
        lim = list(n.shape)
        st[dim], lim[dim] = start, stop
        shape = list(n.shape)
        shape[dim] = max(0, -(-(stop - start) // step))
        strides = None
        if step != 1:
            strides = [1] * len(n.shape)
            strides[dim] = step
            strides = tuple(strides)
        return self.emit("slice", [nid], shape, n.dtype,
                         {"start_indices": tuple(st), "limit_indices": tuple(lim),
                          "strides": strides})

    def reduce(self, op: str, nid: int, dims, keepdim: bool, out_dtype) -> int:
        n = self.g[nid]
        r = len(n.shape)
        axes = tuple(sorted(d % r for d in dims)) if dims else tuple(range(r))
        shape = tuple(s for i, s in enumerate(n.shape) if i not in axes)
        out = self.emit(op, [nid], shape, out_dtype, {"axes": axes})
        if keepdim:
            kept = tuple(i for i in range(r) if i not in axes)
            full = tuple(1 if i in axes else s for i, s in enumerate(n.shape))
            out = self.emit("broadcast", [out], full, self.g[out].dtype,
                            {"shape": full, "broadcast_dimensions": kept})
        return out

    # -- one fx node ----------------------------------------------------------
    def lower(self, node: torch.fx.Node, env: dict):
        tgt = node.target
        val = node.meta.get("val")
        self._ctx = self._node_ctx(node)

        def arg(a):
            if isinstance(a, torch.fx.Node):
                v = env[a]
                return [Ref(i) for i in v] if isinstance(v, list) else Ref(v)
            if isinstance(a, (list, tuple)):
                return type(a)(arg(x) for x in a)
            return a

        args = [arg(a) for a in node.args]
        kwargs = {k: arg(v) for k, v in node.kwargs.items()}
        if tgt is operator.getitem:
            return args[0][args[1]]
        packet = getattr(tgt, "overloadpacket", None)
        if packet is not None and packet.__name__.endswith("_") \
                and not packet.__name__.startswith("_"):
            # an in-place op: fx maps later uses of the mutated tensor to this
            # node, so it lowers as its functional form
            packet = getattr(_A, packet.__name__[:-1], packet)
        shape = tuple(val.shape) if isinstance(val, torch.Tensor) else ()
        dtype = val.dtype if isinstance(val, torch.Tensor) else None
        if packet in self._c10d:
            return self._collective(self._c10d[packet], args, shape, dtype, node.meta)
        if packet in _IDENTITY:
            return args[0]
        if packet in _RESHAPE:
            return self.reshape(args[0], shape)
        if packet is _A.unsqueeze:  # x[:, None]: lax.expand_dims
            new = node.meta.get("inserted", [args[1] % len(shape)])
            return self.emit("broadcast", [args[0]], shape, dtype,
                             {"shape": shape, "broadcast_dimensions":
                              tuple(i for i in range(len(shape)) if i not in new)})
        if packet in _UNARY:
            return self.emit(_UNARY[packet], [self.convert(args[0], dtype)], shape, dtype)
        if packet is _A.reciprocal:  # c / x: see _fold_jnp_forms
            return self.emit("div", [self.scalar(node.meta.get("numerator", 1), dtype),
                                     args[0]], shape, dtype)
        if packet is _A.rsub:  # rsub(x, c) = c - x
            a = self.operand(args[0], dtype)
            b = self.operand(args[1], dtype)
            return self.emit("sub", [self.promote_rank(b, len(shape)),
                                     self.promote_rank(a, len(shape))], shape, dtype)
        if packet in _BINARY:
            return self._binary(_BINARY[packet], node, args, kwargs, shape, dtype)
        if packet in _COMPARE or packet in _LOGICAL:
            op = _COMPARE.get(packet) or _LOGICAL[packet]
            ins = args[:2]
            tensors = [self.g[i].dtype for i in ins if isinstance(i, Ref)]
            common = _promote([_DTYPES_BY_NAME[t] for t in tensors])
            ids = [self.promote_rank(self.convert(self.operand(a, common), common),
                                     len(shape)) for a in ins]
            return self.emit(op, ids, shape, dtype)
        if packet is _A.where:
            c, a, b = (self.operand(x, dtype) for x in args[:3])
            c = self.broadcast_to(c, shape)
            a = self.broadcast_to(self.convert(a, dtype), shape)
            b = self.broadcast_to(self.convert(b, dtype), shape)
            return self.emit("select", [c, b, a], shape, dtype)
        if packet is _A.silu:
            x = args[0]
            lg = self._logistic[x] = self.emit("logistic", [x], shape, dtype)
            return self.emit("mul", [x, lg], shape, dtype)
        if packet is _A.silu_backward:
            return self._silu_backward(args[0], args[1], shape, dtype)
        if packet is _A.masked_fill:  # jnp.where(mask, value, x), value a weak scalar
            c = self.broadcast_to(args[1], shape)
            v = args[2] if isinstance(args[2], Ref) else self.weak_scalar(args[2], dtype)
            v = self.broadcast_to(v, shape)
            return self.emit("select", [c, args[0], v], shape, dtype)
        if packet is _A.select_backward:  # the transpose of x[i]
            return self._select_backward(args, shape, dtype)
        if packet is _A.slice_backward:  # the transpose of lax.slice
            _, _, dim, start, end, step = args
            n = shape[dim % len(shape)]
            start, end = _norm(start, n), _norm(end, n)
            return self._pad_zeros(args[0], dim % len(shape), start,
                                   n - start - (self.g[args[0]].shape[dim] - 1) * step - 1,
                                   step - 1, shape, dtype)
        if packet is _A.relu:
            return self.emit("max", [args[0], self.scalar(0, dtype)], shape, dtype)
        if packet is _A.index_copy and self.g[args[2]].shape in ((), (1,)):
            return self._index_copy(args, shape, dtype)
        if packet is _A.copy:  # the functional copy_: src cast into dst's shape
            return self.broadcast_to(self.convert(args[1], dtype), shape)
        if packet is _A.softplus and tuple(args[1:]) in ((), (1, 20)):
            return self._softplus(args[0], shape, dtype)
        if packet is _A.softplus_backward and tuple(args[2:]) == (1, 20):
            return self._softplus_backward(args[0], args[1], shape, dtype)
        if packet is _A.gelu and kwargs.get("approximate", "none") == "tanh":
            return self._gelu_tanh(args[0], shape, dtype)
        if packet is _A.gelu_backward and kwargs.get("approximate", "none") == "tanh":
            return self._gelu_tanh_backward(args[0], args[1], shape, dtype)
        if packet is _A.flip:  # lax.rev
            return self.emit("rev", [args[0]], shape, dtype,
                             {"dimensions": tuple(sorted(d % len(shape) for d in args[1]))})
        if packet is _A.constant_pad_nd:
            return self._pad(args, shape, dtype)
        if packet is _A.cumsum:
            x = self.convert(args[0], dtype)
            return self.emit("cumsum", [x], shape, dtype,
                             {"axis": args[1] % len(shape),
                              "reverse": node.meta.get("reverse", False)})
        if packet is _A.clamp:  # jnp.clip: max(lo, x), then min(hi, .)
            x = args[0]
            lo = args[1] if len(args) > 1 else kwargs.get("min")
            hi = args[2] if len(args) > 2 else kwargs.get("max")
            if lo is not None:
                x = self.emit("max", [self.operand(lo, dtype), x], shape, dtype)
            if hi is not None:
                x = self.emit("min", [self.operand(hi, dtype), x], shape, dtype)
            return x
        if packet in (_A.clamp_min, _A.clamp_max):  # jnp.maximum / jnp.minimum
            return self.emit("max" if packet is _A.clamp_min else "min",
                             [args[0], self.operand(args[1], dtype)], shape, dtype)
        if packet is _A._to_copy:
            return self.convert(args[0], kwargs.get("dtype") or dtype)
        if packet in (_A.permute, _A.transpose, _A.t, _A.numpy_T):
            r = len(self.g[args[0]].shape)
            if packet is _A.permute:
                perm = tuple(d % r for d in args[1])
            else:
                a, b = (args[1] % r, args[2] % r) if packet is _A.transpose else (0, 1)
                perm = list(range(r))
                perm[a], perm[b] = perm[b], perm[a]
                perm = tuple(perm)
            if perm == tuple(range(r)):
                return args[0]
            return self.emit("transpose", [args[0]], shape, dtype, {"permutation": perm})
        if packet is _A.expand:
            return self.broadcast_to(args[0], shape)
        if packet is _A.slice:
            x = self.g[args[0]]
            dim = (args[1] if len(args) > 1 else 0) % len(x.shape)
            n = x.shape[dim]
            start = args[2] if len(args) > 2 and args[2] is not None else 0
            stop = args[3] if len(args) > 3 and args[3] is not None else n
            step = args[4] if len(args) > 4 else 1
            start, stop = _norm(start, n), _norm(stop, n)
            return self.slice(args[0], dim, start, max(start, stop), step)
        if packet is _A.narrow:
            x = self.g[args[0]]
            dim = args[1] % len(x.shape)
            start = _norm(args[2], x.shape[dim])
            return self.slice(args[0], dim, start, start + args[3])
        if packet is _A.select:
            x = self.g[args[0]]
            dim = args[1] % len(x.shape)
            i = args[2] % x.shape[dim]
            return self.reshape(self.slice(args[0], dim, i, i + 1, whole=True), shape)
        if packet in (_A.split, _A.split_with_sizes, _A.chunk, _A.unbind):
            return self._split(packet, args, node)
        if packet is _A.cat:
            ts = [t for t in args[0] if self.g[t].size or len(args[0]) == 1]
            if len(ts) == 1:
                return ts[0]
            dim = (args[1] if len(args) > 1 else 0) % len(shape)
            return self.emit("concat", [self.convert(t, dtype) for t in ts], shape, dtype,
                             {"dimension": dim})
        if packet is _A.stack:  # jnp.stack: expand_dims each, then concatenate
            dim = (args[1] if len(args) > 1 else 0) % len(shape)
            unit = shape[:dim] + (1,) + shape[dim + 1:]
            kept = tuple(i for i in range(len(shape)) if i != dim)
            ts = [self.emit("broadcast", [self.convert(t, dtype)], unit, dtype,
                            {"shape": unit, "broadcast_dimensions": kept})
                  for t in args[0]]
            if len(ts) == 1:
                return ts[0]
            return self.emit("concat", ts, shape, dtype, {"dimension": dim})
        if packet is getattr(torch.ops.repro_torch, "dot_general", None):
            lc, rc, lb, rb = (tuple(x) for x in args[2:6])
            ins = (args[:2] if args[6]  # preferred_element_type=float32
                   else [self.convert(a, dtype) for a in args[:2]])
            return self.emit("dot", ins, shape, dtype,
                             {"dimension_numbers": ((lc, rc), (lb, rb))})
        if packet is getattr(torch.ops.repro_torch, "dynamic_slice", None):
            return self._dynamic_slice(args, shape, dtype)
        if packet is getattr(torch.ops.repro_torch, "take", None):
            return self._take(args, shape, dtype)
        if packet is getattr(torch.ops.repro_torch, "take_transpose", None):
            return self._take_transpose_op(args, shape, dtype)
        if packet is getattr(torch.ops.repro_torch, "top_k", None):
            # lax.top_k: one node for each output, the values and the indices
            x, k = args
            params = {"axis": len(self.g[x].shape) - 1, "k": k}
            return [self.emit("top_k", [x], tuple(v.shape), v.dtype, params)
                    for v in val]
        if packet is _A.repeat:
            out = self._repeat(args[0], tuple(args[1]), shape, dtype)
            if out is not None:
                return out
        if packet is _A.index_put and len(args) > 3 and args[3]:
            out = self._scatter_add(args, shape, dtype)
            if out is not None:
                return out
        if packet is _A.mm:
            return self.emit("dot", args[:2], shape, dtype,
                             {"dimension_numbers": (((1,), (0,)), ((), ()))})
        if packet is _A.bmm:
            return self.emit("dot", args[:2], shape, dtype,
                             {"dimension_numbers": (((2,), (1,)), ((0,), (0,)))})
        if packet is _A.addmm:  # bias + a @ b
            d = self.emit("dot", args[1:3], shape, dtype,
                          {"dimension_numbers": (((1,), (0,)), ((), ()))})
            return self.emit("add", [d, self.promote_rank(args[0], len(shape))], shape,
                             dtype)
        if packet in _REDUCE:
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            if isinstance(dims, int):
                dims = [dims]
            keep = (args[2] if len(args) > 2 else kwargs.get("keepdim", False))
            x = args[0]
            if packet is _A.sum and dtype is not None:
                x = self.convert(x, dtype)
            return self.reduce(_REDUCE[packet], x, dims, bool(keep), dtype)
        if packet is _A.mean:
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
            x = self.g[args[0]]
            r = len(x.shape)
            axes = [d % r for d in dims] if dims else list(range(r))
            count = int(np.prod([x.shape[d] for d in axes]))
            s = self.reduce("reduce_sum", args[0], axes, bool(keep), dtype)
            return self.emit("div", [s, self.scalar(count, dtype)], shape, dtype)
        if packet is _A._softmax:  # jax.nn.softmax's lowering
            x, dim = args[0], args[1] % len(shape)
            m = self.reduce("reduce_max", x, [dim], False, dtype)
            # the max floored at -inf, kept dims back, and stop_gradient
            m = self.emit("max", [self.scalar(-math.inf, dtype), m], self.g[m].shape,
                          dtype)
            kept = tuple(s if i != dim else 1 for i, s in enumerate(shape))
            m = self.emit("broadcast", [m], kept, dtype,
                          {"shape": kept, "broadcast_dimensions":
                           tuple(i for i in range(len(shape)) if i != dim)})
            m = self.emit("copy", [m], kept, dtype)
            e = self.emit("exp", [self.emit("sub", [x, m], shape, dtype)], shape, dtype)
            s = self.reduce("reduce_sum", e, [dim], True, dtype)
            return self.emit("div", [e, s], shape, dtype)
        if packet in (_A.triu, _A.tril):
            return self._tri(packet, args, shape, dtype)
        if packet in (_A.embedding, _A.index):
            return self._gather(packet, args, shape, dtype)
        if packet in _FILL:
            return self._fill(packet, args, kwargs, shape, dtype)
        if packet is _A.arange:
            return self._arange(args, kwargs, shape, dtype)
        # anything else: an opaque node named after the op
        params = {k: v for k, v in kwargs.items() if isinstance(v, (int, float, bool, str))}
        params["target"] = str(tgt)
        ins = [a for a in args if isinstance(a, Ref)]
        name = packet.__name__ if packet is not None else str(tgt)
        return self.emit(name, ins, shape, dtype or torch.float32, params)

    # -- helpers for the cases above -------------------------------------------
    def _node_ctx(self, node):
        custom = node.meta.get("custom") or {}
        scope = custom.get("scope", "")
        src = node.meta.get("stack_trace") or ""
        return src, scope, self.layer_tag_fn(scope), custom.get("mult", 1)

    def _binary(self, op, node, args, kwargs, shape, dtype):
        a = self.operand(args[0], dtype)
        b = self.operand(args[1], dtype)
        alpha = kwargs.get("alpha", 1)
        if node.kwargs.get("rounding_mode") is not None:
            op = f"div_{node.kwargs['rounding_mode']}"
        if op == "pow" and not isinstance(args[1], Ref) and float(args[1]).is_integer():
            x = self.convert(a, dtype)
            return self.emit("integer_pow", [x], shape, dtype, {"y": int(args[1])})
        a = self.promote_rank(self.convert(a, dtype), len(shape))
        b = self.promote_rank(self.convert(b, dtype), len(shape))
        if alpha != 1:
            b = self.emit("mul", [b, self.scalar(alpha, dtype)], self.g[b].shape, dtype)
        return self.emit(op, [a, b], shape, dtype)

    def _index_copy(self, args, shape, dtype):
        """``index_copy`` of one index: ``lax.dynamic_update_slice_in_dim``
        at that index (the write index comes in already wrapped and
        clamped; a scalar where ``_fold_written_views`` found one)."""
        x, dim, idx, src = args[0], args[1] % len(shape), args[2], args[3]
        starts = [self.scalar(0, torch.int64)] * len(shape)
        starts[dim] = self.reshape(idx, ())
        return self.emit("dynamic_update_slice", [x, self.convert(src, dtype)] + starts,
                         shape, dtype)

    def _dynamic_slice(self, args, shape, dtype):
        """``lax.dynamic_slice_in_dim(x, s, size, axis)``: jnp wraps a
        negative start once (``select(s < 0, s, s + n)``), the other dims
        start at a constant zero, and ``dynamic_slice`` clamps."""
        x, start, axis, _ = args
        idt = _DTYPES_BY_NAME[self.g[start].dtype]
        zero = self.scalar(0, idt)
        lt = self.emit("lt", [start, zero], (), torch.bool)
        wrapped = self.emit("add", [start, self.scalar(self.g[x].shape[axis], idt)], (), idt)
        starts = [zero] * len(shape)
        starts[axis] = self.emit("select", [lt, start, wrapped], (), idt)
        return self.emit("dynamic_slice", [x] + starts, shape, dtype,
                         {"slice_sizes": tuple(shape)})

    def _take_index_vector(self, ids, rows: int) -> int:
        """``jnp.take``'s indices: a negative id wrapped once (``select(i <
        0, i, i + rows)``) and given a trailing index-vector dim."""
        key = (ids, rows)
        if key not in self._take_index:
            n = self.g[ids]
            idt = _DTYPES_BY_NAME[n.dtype]
            neg = self.emit("lt", [ids, self.scalar(0, idt)], n.shape, torch.bool)
            plus = self.emit("add", [ids, self.scalar(rows, idt)], n.shape, idt)
            w = self.emit("select", [neg, ids, plus], n.shape, idt)
            iv = n.shape + (1,)
            self._take_index[key] = self.emit(
                "broadcast", [w], iv, idt,
                {"shape": iv, "broadcast_dimensions": tuple(range(len(n.shape)))})
        return self._take_index[key]

    def _take(self, args, shape, dtype):
        """``jnp.take(table, ids, axis=0)``: one ``gather`` whose fill is
        NaN, with lax's dimension numbers."""
        table, ids = args
        row = self.g[table].shape[1:]
        k = len(self.g[ids].shape)
        dn = (f"GatherDimensionNumbers(offset_dims={tuple(range(k, k + len(row)))}, "
              f"collapsed_slice_dims=(0,), start_index_map=(0,), operand_batching_dims=(), "
              f"start_indices_batching_dims=())")
        iv = self._take_index_vector(ids, self.g[table].shape[0])
        return self.emit("gather", [table, iv], shape, dtype,
                         {"dimension_numbers": dn, "fill_value": math.nan,
                          "indices_are_sorted": False, "slice_sizes": (1, *row),
                          "unique_indices": False})

    def _take_transpose_op(self, args, shape, dtype):
        """``take``'s transpose as JAX's: a zero table and one
        ``scatter_add`` at the forward's index vector."""
        g, ids, rows = args
        iv = self._take_index_vector(ids, rows)
        zero = self.broadcast_to(self.scalar(0, dtype), shape)
        k = len(self.g[ids].shape)
        window = tuple(range(k, len(self.g[g].shape)))
        dn = (f"ScatterDimensionNumbers(update_window_dims={window}, "
              f"inserted_window_dims=(0,), scatter_dims_to_operand_dims=(0,), "
              f"operand_batching_dims=(), scatter_indices_batching_dims=())")
        return self.emit("scatter_add", [zero, iv, self.convert(g, dtype)], shape, dtype,
                         {"dimension_numbers": dn, "indices_are_sorted": False,
                          "slice_sizes": (), "unique_indices": False,
                          "update_consts": ()})

    def _repeat(self, x, reps, shape, dtype):
        """``jnp.repeat(x, r, axis=d)`` for a unit dim ``d`` (where torch's
        tiling ``repeat`` is the same): one ``broadcast_in_dim`` to a new
        dim of ``r`` after ``d``, then a ``reshape``; None for any other
        repeat."""
        n = self.g[x]
        grown = [d for d, r in enumerate(reps) if r != 1]
        if len(reps) != len(n.shape) or len(grown) != 1 or n.shape[grown[0]] != 1:
            return None
        d = grown[0]
        wide = n.shape[:d + 1] + (reps[d],) + n.shape[d + 1:]
        b = self.emit("broadcast", [x], wide, dtype,
                      {"shape": wide, "broadcast_dimensions":
                       tuple(i for i in range(len(wide)) if i != d + 1)})
        return self.reshape(b, shape)

    def _scatter_add(self, args, shape, dtype):
        """``x.at[i0, i1, ...].add(u)`` for 1-D indices into every leading
        dim and a 1-D ``u`` (``index_put`` with ``accumulate``), as jnp
        traces it: each index wrapped once (``select(i < 0, i, i + n)``)
        and given a trailing unit dim, the columns concatenated, one
        ``scatter_add`` of one element per row; None for other forms."""
        x, indices, upd = args[0], args[1], args[2]
        n = self.g[x]
        if len(indices) == 1 and indices[0] is not None:
            return self._take_transpose(x, indices[0], upd, shape, dtype)
        if (len(indices) != len(n.shape) or any(i is None for i in indices)
                or len({self.g[i].shape for i in indices}) != 1
                or len(self.g[indices[0]].shape) != 1
                or self.g[upd].shape != self.g[indices[0]].shape):
            return None
        rows = self.g[indices[0]].shape[0]
        wrapped = []
        for size, i in zip(n.shape, indices):
            idt = _DTYPES_BY_NAME[self.g[i].dtype]
            neg = self.emit("lt", [i, self.scalar(0, idt)], (rows,), torch.bool)
            plus = self.emit("add", [i, self.scalar(size, idt)], (rows,), idt)
            wrapped.append(self.emit("select", [neg, i, plus], (rows,), idt))
        cols = [self.emit("broadcast", [i], (rows, 1), self.g[i].dtype,
                          {"shape": (rows, 1), "broadcast_dimensions": (0,)})
                for i in wrapped]
        idx = cols[0] if len(cols) == 1 else self.emit(
            "concat", cols, (rows, len(cols)), self.g[cols[0]].dtype, {"dimension": 1})
        dims = tuple(range(len(n.shape)))
        dn = (f"ScatterDimensionNumbers(update_window_dims=(), inserted_window_dims={dims}, "
              f"scatter_dims_to_operand_dims={dims}, operand_batching_dims=(), "
              f"scatter_indices_batching_dims=())")
        return self.emit("scatter_add", [x, idx, self.convert(upd, dtype)], shape, dtype,
                         {"dimension_numbers": dn, "indices_are_sorted": False,
                          "slice_sizes": (), "unique_indices": False,
                          "update_consts": ()})

    def _take_transpose(self, x, idx, upd, shape, dtype):
        """``zeros.at[idx].add(u)`` along dim 0 as JAX transposes
        ``jnp.take(table, idx, axis=0)`` (an embedding's gradient): the
        indices given a trailing index-vector dim (a ``broadcast``) and one
        ``scatter_add`` with the gather's dimension numbers; None unless
        ``u`` is ``idx``'s shape followed by a row of ``x``."""
        ishape, rows = self.g[idx].shape, self.g[x].shape[1:]
        if self.g[upd].shape != ishape + rows:
            return None
        k = len(ishape)
        iv = self.emit("broadcast", [idx], ishape + (1,), self.g[idx].dtype,
                       {"shape": ishape + (1,), "broadcast_dimensions": tuple(range(k))})
        window = tuple(range(k, k + len(rows)))
        dn = (f"ScatterDimensionNumbers(update_window_dims={window}, "
              f"inserted_window_dims=(0,), scatter_dims_to_operand_dims=(0,), "
              f"operand_batching_dims=(), scatter_indices_batching_dims=())")
        return self.emit("scatter_add", [x, iv, self.convert(upd, dtype)], shape, dtype,
                         {"dimension_numbers": dn, "indices_are_sorted": False,
                          "slice_sizes": (), "unique_indices": False,
                          "update_consts": ()})

    def _silu_backward(self, ct, x, shape, dtype):
        """The transpose of ``jax.nn.silu``'s JVP, ``x * s`` with ``s =
        logistic(x)`` and ``ds = dx * (s * (1 - s))``: ``ct * s + (x * ct) *
        (s * (1 - s))``, each step in x's dtype, ``s`` the forward's
        (a residual) where the trace has it."""
        s = self._logistic.get(x)
        if s is None:
            s = self.emit("logistic", [x], shape, dtype)
        r = self.emit("mul", [s, self.emit("sub", [self.scalar(1, dtype), s], shape, dtype)],
                      shape, dtype)
        a = self.emit("mul", [ct, s], shape, dtype)
        b = self.emit("mul", [x, ct], shape, dtype)
        return self.emit("add", [a, self.emit("mul", [b, r], shape, dtype)], shape, dtype)

    def _pad_zeros(self, x, dim: int, lo: int, hi: int, interior: int, shape, dtype):
        """lax's transpose of a static slice along ``dim``: one ``pad`` of
        the cotangent with a zero of its dtype."""
        config = [(0, 0, 0)] * len(shape)
        config[dim] = (lo, hi, interior)
        return self.emit("pad", [x, self.scalar(0, dtype)], shape, dtype,
                         {"padding_config": tuple(config)})

    def _select_backward(self, args, shape, dtype):
        """The transpose of ``x[i]`` (``lax.index_in_dim``'s slice, then its
        squeeze): the unit dim back (``expand_dims``, a ``broadcast``), then
        zeros padded around it."""
        g, _, dim, i = args
        dim = dim % len(shape)
        i = i % shape[dim]
        unit = shape[:dim] + (1,) + shape[dim + 1:]
        b = self.emit("broadcast", [g], unit, dtype,
                      {"shape": unit, "broadcast_dimensions":
                       tuple(d for d in range(len(shape)) if d != dim)})
        return self._pad_zeros(b, dim, i, shape[dim] - i - 1, 0, shape, dtype)

    def _softplus(self, x, shape, dtype):
        """``jax.nn.softplus``: ``logaddexp(x, 0)``, whose jnp lowering is
        ``select(isnan(x - 0), max(x, 0) + log1p(exp(-|x - 0|)), x + 0)``
        (torch's default threshold of 20 only shortcuts the same value)."""
        zero = self.scalar(0.0, dtype)
        amax = self.emit("max", [x, zero], shape, dtype)
        delta = self.emit("sub", [x, zero], shape, dtype)
        isnan = self.emit("ne", [delta, delta], shape, torch.bool)
        both = self.emit("add", [x, zero], shape, dtype)
        t = self.emit("abs", [delta], shape, dtype)
        for op in ("neg", "exp", "log1p"):
            t = self.emit(op, [t], shape, dtype)
        out = self.emit("add", [amax, t], shape, dtype)
        self._softplus_out[x] = self.emit("select", [isnan, out, both], shape, dtype)
        return self._softplus_out[x]

    def _softplus_backward(self, ct, x, shape, dtype):
        """``logaddexp``'s JVP in ``jax.nn.softplus``: ``ct * exp(x' -
        y')``, ``y`` the forward's value and each of ``x``, ``y`` with +inf
        replaced by 0 (``_replace_inf``)."""
        y = self._softplus_out.get(x)
        if y is None:
            y = self._softplus(x, shape, dtype)
        inf = self.scalar(math.inf, dtype)
        xs, ys = (self.emit("select", [self.emit("eq", [v, inf], shape, torch.bool), v,
                                       self.broadcast_to(self.scalar(0.0, dtype), shape)],
                            shape, dtype) for v in (x, y))
        c = self.emit("exp", [self.emit("sub", [xs, ys], shape, dtype)], shape, dtype)
        return self.emit("mul", [ct, c], shape, dtype)

    def _gelu_tanh(self, x, shape, dtype):
        """``jax.nn.gelu`` (``approximate=True``): ``x * (0.5 * (1 + tanh(
        sqrt(2/pi) * (x + 0.044715 * x**3))))``, the constants in x's dtype."""
        th, cdf = self._gelu_residuals(x, shape, dtype)
        return self.emit("mul", [x, cdf], shape, dtype)

    def _gelu_residuals(self, x, shape, dtype):
        """The tanh and the cdf of ``jax.nn.gelu(x, approximate=True)``,
        emitted once per ``x`` (its backward reuses them, as JAX's
        linearization keeps them)."""
        if x not in self._gelu:
            cube = self.emit("integer_pow", [x], shape, dtype, {"y": 3})
            t = self.emit("mul", [self.scalar(0.044715, dtype), cube], shape, dtype)
            t = self.emit("add", [x, t], shape, dtype)
            t = self.emit("mul", [self.scalar(math.sqrt(2 / math.pi), dtype), t], shape,
                          dtype)
            th = self.emit("tanh", [t], shape, dtype)
            t = self.emit("add", [self.scalar(1.0, dtype), th], shape, dtype)
            self._gelu[x] = th, self.emit("mul", [self.scalar(0.5, dtype), t], shape, dtype)
        return self._gelu[x]

    def _gelu_tanh_backward(self, ct, x, shape, dtype):
        """The transpose of the tanh ``jax.nn.gelu``'s JVP, op for op as
        JAX's backward pass forms it (``tanh``'s JVP ``(g + g * t) * (1 -
        t)``, ``integer_pow``'s ``g * (3 * x**2)``)."""
        th, cdf = self._gelu_residuals(x, shape, dtype)

        def mul(a, b):
            return self.emit("mul", [a, b], shape, dtype)

        def add(a, b):
            return self.emit("add", [a, b], shape, dtype)

        u = mul(mul(self.scalar(0.5, dtype), mul(x, ct)),
                self.emit("sub", [self.scalar(1.0, dtype), th], shape, dtype))
        t2 = mul(self.scalar(math.sqrt(2 / math.pi), dtype), add(u, mul(u, th)))
        sq = self.emit("integer_pow", [x], shape, dtype, {"y": 2})
        t3 = mul(mul(self.scalar(0.044715, dtype), t2), mul(self.scalar(3.0, dtype), sq))
        return add(add(mul(ct, cdf), t2), t3)

    def _pad(self, args, shape, dtype):
        """``jnp.pad`` with a constant: one ``pad`` with a (low, high,
        interior) entry per dim; torch lists (low, high) from the last dim."""
        x = self.g[args[0]]
        flat = list(args[1])
        config = [(0, 0, 0)] * len(x.shape)
        for i in range(len(flat) // 2):
            config[len(x.shape) - 1 - i] = (flat[2 * i], flat[2 * i + 1], 0)
        value = args[2] if len(args) > 2 and args[2] is not None else 0
        value = int(value) if value == 0 else value  # jnp.pad's constant_values=0
        return self.emit("pad", [args[0], self.weak_scalar(value, dtype)], shape, dtype,
                         {"padding_config": tuple(config)})

    def _collective(self, name, args, shape, dtype, meta):
        if name == "wait_tensor":
            return args[0]
        params = {"axes": (self.group_axes[args[-1]],), "groups": "full"}
        if name == "all_reduce":
            params["reduce_op"] = _REDUCE_OPS[args[1]]
            return self.emit("all_reduce", [args[0]], shape, dtype, params)
        if name == "all_gather_into_tensor":
            params.update(all_gather_dimension=meta.get("gather_dim", 0), tiled=True)
            return self.emit("all_gather", [args[0]], shape, dtype, params)
        if name == "reduce_scatter_tensor":
            params.update(scatter_dimension=meta.get("scatter_dim", 0), tiled=True,
                          reduce_op=_REDUCE_OPS[args[1]])
            return self.emit("reduce_scatter", [args[0]], shape, dtype, params)
        params.update(split_axis=0, concat_axis=0, tiled=True)
        return self.emit("all_to_all", [args[0]], shape, dtype, params)

    def _split(self, packet, args, node):
        x = self.g[args[0]]
        vals = node.meta.get("val")
        if packet is _A.unbind:
            dim = (args[1] if len(args) > 1 else 0) % len(x.shape)
            return [self.reshape(self.slice(args[0], dim, i, i + 1), tuple(v.shape))
                    for i, v in enumerate(vals)]
        dim = (args[2] if len(args) > 2 else 0) % len(x.shape)
        outs, start = [], 0
        for v in vals:
            n = v.shape[dim]
            outs.append(self.slice(args[0], dim, start, start + n))
            start += n
        return outs

    def _tri(self, packet, args, shape, dtype):
        """``jnp.tril``/``jnp.triu``: a row/column iota mask and a select."""
        k = args[1] if len(args) > 1 else 0
        r, c = shape[-2], shape[-1]
        i32 = torch.int64
        rows = self.emit("iota", [], (r, c), i32, {"dimension": 0, "shape": (r, c)})
        cols = self.emit("iota", [], (r, c), i32, {"dimension": 1, "shape": (r, c)})
        rk = self.emit("add", [rows, self.scalar(k, i32)], (r, c), i32)
        op = "ge" if packet is _A.tril else "le"
        mask = self.emit(op, [rk, cols], (r, c), torch.bool)
        mask = self.broadcast_to(mask, shape)
        zero = self.broadcast_to(self.scalar(0, dtype), shape)
        return self.emit("select", [mask, zero, args[0]], shape, dtype)

    def _gather(self, packet, args, shape, dtype):
        if packet is _A.embedding:
            table, idx = args[0], args[1]
            return self.emit("gather", [table, idx], shape, dtype, {"axis": 0})
        x, indices = args[0], args[1]
        dims = tuple(i for i, t in enumerate(indices) if t is not None)
        ins = [x] + [t for t in indices if t is not None]
        return self.emit("gather", ins, shape, dtype, {"axis": dims[0]} if len(dims) == 1
                         else {"index_dims": dims})

    def _fill(self, packet, args, kwargs, shape, dtype):
        value = _FILL[packet]
        if value is None:
            if packet is _A.scalar_tensor:
                value = args[0]
            elif packet is _A.full_like:
                value = args[1]
            elif packet is _A.new_full:
                value = args[2]
            else:
                value = args[1]
        c = self.scalar(value, dtype)
        if not shape:
            return c
        return self.emit("broadcast", [c], shape, dtype,
                         {"shape": shape, "broadcast_dimensions": ()})

    def _arange(self, args, kwargs, shape, dtype):
        nums = [a for a in args if not isinstance(a, torch.dtype)]
        start, end, step = (0, nums[0], 1) if len(nums) == 1 else (
            nums[0], nums[1], nums[2] if len(nums) > 2 else 1)
        if start == 0 and step == 1 and not dtype.is_floating_point:
            return self.emit("iota", [], shape, dtype, {"dimension": 0, "shape": shape})
        vals = torch.arange(start, end, step, dtype=dtype).to(torch.float64
                                                              if dtype.is_floating_point
                                                              else torch.int64)
        return self.add_const(vals.numpy().astype(_NP_DTYPES[dtype]), dtype_name(dtype))


def _norm(i: int, n: int) -> int:
    if i < 0:
        i += n
    return min(max(i, 0), n)


def _promote(dtypes) -> torch.dtype:
    out = dtypes[0] if dtypes else torch.int64
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out


# --------------------------------------------------------------------------
# entry points


def _fake_inputs(mode, leaves) -> list:
    with mode:
        return [torch.empty(tuple(leaf.shape), dtype=leaf.dtype) for leaf in leaves]


def _lower(gm, name: str, layer_tag_fn, group_axes: Optional[dict] = None,
           rank_axes: tuple = ()):
    """The fx graph of ``gm`` as a :class:`Graph`.  ``group_axes`` maps each
    process-group name to its mesh axis; the first ``len(rank_axes)``
    placeholders are the ranks along those axes, each emitted as one
    ``axis_index`` over its axis for each op that reads it, where that op is
    (as ``lax.axis_index`` appears at each place the JAX code calls it: the
    vocab-parallel embedding's offset, a frontend's SP slice); a rank no op
    reads leaves no node."""
    t = Tracer(layer_tag_fn, group_axes)
    t.g.name = name
    env: dict = {}
    in_ids: list[int] = []
    rank_nodes: dict = {}
    outs: list[int] = []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            v = node.meta["val"]
            if len(rank_nodes) < len(rank_axes):
                rank_nodes[node] = rank_axes[len(rank_nodes)]
                continue
            nid = t.g.add("input", (), tuple(v.shape), dtype_name(v.dtype),
                          {"arg": len(in_ids)})
            in_ids.append(nid)
            env[node] = nid
        elif node.op == "get_attr":
            tensor = getattr(gm, node.target)
            env[node] = t.add_const(tensor.detach().to(
                torch.float32 if tensor.dtype == torch.bfloat16 else tensor.dtype
            ).numpy(), dtype_name(tensor.dtype))
        elif node.op == "call_function":
            for rank_node, axis in rank_nodes.items():
                if rank_node in node.args:
                    t._ctx = t._node_ctx(node)
                    env[rank_node] = t.emit("axis_index", [], (),
                                            dtype_name(rank_node.meta["val"].dtype),
                                            {"axes": (axis,), "groups": "full"})
            env[node] = t.lower(node, env)
        elif node.op == "output":
            torch.fx.node.map_arg(node.args[0], lambda a: outs.append(env[a]))
    t.g.mark_output(*outs)
    t.g.input_alias = {}
    return t.g, in_ids, outs


def _make_fx(flat_fn, fakes, grad: bool = False):
    """``flat_fn`` traced functionalized: a program that writes its inputs
    in place (a serving step and its caches) returns what it writes, and a
    pure program traces as it would unfunctionalized.  ``grad``: a pure
    program that differentiates with ``torch.autograd`` (functionalize
    cannot take ``requires_grad_``), traced as it runs; the in-place ops of
    its backward pass become their functional forms, and each backward op
    takes the source and scope of the forward call it differentiates
    (``_SourceMode``'s pre-hooks on the autograd nodes)."""
    gm = _program(flat_fn, fakes, grad)
    if not grad:
        _fold_written_views(gm)  # first: it reads views that are dead until it runs
    _fold_collective_dims(gm)
    _fold_jnp_forms(gm)
    return gm


def _program(flat_fn, fakes, grad: bool):
    """The executable fx program of :func:`_make_fx`, before the folds
    that only the lowering reads."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.scope import recompute_under

    mode = _SourceMode(grad=grad)
    with fx_traceback.preserve_node_meta(), mode, recompute_under(mode):
        gm = make_fx(flat_fn if grad else torch.func.functionalize(flat_fn),
                     tracing_mode="fake")(*fakes)
    if grad:
        _fold_inplace(gm)
    return gm


def fx_program(fn: Callable, *args, grad: bool = False):
    """The fx program :func:`trace` lowers, before the folds only the
    lowering reads: a GraphModule over the flat leaves of ``args`` (tensors
    or :class:`ShapeDtype`s, traced as fake tensors) that returns the flat
    leaves of ``fn(*args)`` and runs on real tensors, so a traced program
    can be held to numbers (the gradient path's in-place folds included).
    A program with collectives runs in a process of the group it was
    traced in."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    leaves, treedef = _leaf_shapes(args)

    def flat_fn(*flat):
        return tree_leaves(fn(*tree_unflatten(treedef, flat)))

    return _program(flat_fn, _fake_inputs(FakeTensorMode(), leaves), grad)


def _fold_inplace(gm) -> None:
    """Each in-place op of a traced backward pass (``masked_fill_`` in
    ``maximum``'s) as its functional form: fx already maps the later uses
    of the written tensor to the op's node.  Sound only where nothing reads
    the memory after the write through another node (a view of the tensor,
    or the tensor a view of which it is, taken before the write), which is
    checked."""
    order = {n: i for i, n in enumerate(gm.graph.nodes)}
    for node in list(gm.graph.nodes):
        packet = getattr(node.target, "overloadpacket", None)
        name = getattr(packet, "__name__", "")
        if not name.endswith("_") or name.startswith("_"):
            continue
        aliases = _aliases(node.args[0])
        late = [a for a in aliases if a.op == "placeholder"
                or any(order[u] > order[node] for u in a.users if u is not node)]
        if late:
            raise NotImplementedError(f"{node.target} writes a tensor read after it "
                                      f"({late[0].name}); only fresh values fold")
        node.target = getattr(getattr(_A, name[:-1]), node.target._overloadname)
    gm.recompile()


def _is_view(node) -> bool:
    return node.op == "call_function" and getattr(node.target, "is_view", False)


def _aliases(node) -> list:
    """The nodes that share ``node``'s memory: the views it was taken from
    and the views taken of any of them, transitively."""
    seen, todo = [], [node]
    while todo:
        n = todo.pop()
        if n in seen:
            continue
        seen.append(n)
        if _is_view(n):
            todo.append(n.args[0])
        todo.extend(u for u in n.users if _is_view(u))
    return seen


def _fold_jnp_forms(gm) -> None:
    """ATen spellings of what ``jax.numpy`` traces as one op:

    * ``c / x`` for a Python number ``c`` is ``reciprocal(x) * c`` in ATen
      and one ``div(c, x)`` in jnp: the reciprocal takes ``c`` (its meta
      ``numerator``) and the ``mul`` goes;
    * ``x[:, None, None]`` is one ``unsqueeze`` per new dim in ATen and one
      ``lax.expand_dims`` (a ``broadcast_in_dim``) in jnp: the last
      unsqueeze of a chain takes the chain's input and every inserted dim
      (its meta ``inserted``);
    * ``flip(cumsum(flip(x, d), d), d)``, ATen's backward of a cumsum, is
      one ``cumsum(x, d, reverse=True)``, lax's transpose of it (its meta
      ``reverse``).
    """
    graph = gm.graph
    for node in list(graph.nodes):
        if (node.target is _A.mul.Tensor and isinstance(node.args[1], (int, float))
                and isinstance(node.args[0], torch.fx.Node)
                and node.args[0].target is _A.reciprocal.default
                and len(node.args[0].users) == 1
                and node.args[0].meta["val"].dtype == node.meta["val"].dtype):
            recip = node.args[0]
            recip.meta["numerator"] = node.args[1]
            node.replace_all_uses_with(recip)
            graph.erase_node(node)
        elif node.target is _A.unsqueeze.default:
            inner = node.args[0]
            d = node.args[1] % node.meta["val"].dim()
            if inner.target is _A.unsqueeze.default and len(inner.users) == 1:
                dims = inner.meta.get("inserted", [inner.args[1] % inner.meta["val"].dim()])
                node.meta["inserted"] = sorted([d] + [i + (i >= d) for i in dims])
                node.args = (inner.args[0], d)
        elif node.target is _A.flip.default and len(node.args[1]) == 1:
            cs = node.args[0]
            d = node.args[1][0] % node.meta["val"].dim()
            if (cs.target is _A.cumsum.default and len(cs.users) == 1
                    and cs.args[1] % node.meta["val"].dim() == d
                    and cs.args[0].target is _A.flip.default
                    and len(cs.args[0].users) == 1
                    and [a % node.meta["val"].dim() for a in cs.args[0].args[1]] == [d]):
                cs.meta["reverse"] = True
                cs.args = (cs.args[0].args[0],) + tuple(cs.args[1:])
                node.replace_all_uses_with(cs)
    graph.eliminate_dead_code()
    gm.recompile()


def _chunks_of(parts) -> Optional[tuple]:
    """``(x, dim)`` when ``parts`` are the pieces of one ``split`` of ``x``
    along ``dim``, all of them, in order; None otherwise."""
    if not parts or any(p.target is not operator.getitem for p in parts):
        return None
    split = parts[0].args[0]
    if (split.target is not _A.split.Tensor or len(split.users) != len(parts)
            or [p.args for p in parts] != [(split, i) for i in range(len(parts))]):
        return None
    x = split.args[0]
    dim = split.args[2] if len(split.args) > 2 else 0
    return x, dim % x.meta["val"].dim()


def _fold_collective_dims(gm) -> None:
    """A functional reduce_scatter or all_gather along a dim other than 0
    is traced as a dim-0 collective between a ``split`` and a ``cat``
    (``ParallelCtx.scatter_tp``/``gather_tp``); fold each back into one
    collective along its dim, as ``lax.psum_scatter`` and ``lax.all_gather``
    trace (the dim goes on the node's meta)."""
    graph = gm.graph
    ns = torch.ops._c10d_functional
    for node in list(graph.nodes):
        if node.target is ns.reduce_scatter_tensor.default:
            cat = node.args[0]
            if cat.target is _A.cat.default and (len(cat.args) < 2 or cat.args[1] == 0):
                found = _chunks_of(cat.args[0])
                if found is not None and len(cat.args[0]) == node.args[2]:
                    node.args = (found[0],) + tuple(node.args[1:])
                    node.meta["scatter_dim"] = found[1]
        elif node.target is _A.cat.default and len(node.args) > 1:
            found = _chunks_of(node.args[0])
            if found is None or found[1] != 0:
                continue
            wait = found[0]
            gather = wait.args[0] if wait.target is ns.wait_tensor.default else None
            if (gather is None or gather.target is not ns.all_gather_into_tensor.default
                    or len(node.args[0]) != gather.args[1]
                    or len(wait.users) != 1 or len(gather.users) != 1):
                continue
            gather.meta["gather_dim"] = node.args[1] % node.meta["val"].dim()
            gather.meta["val"] = wait.meta["val"] = node.meta["val"]
            node.replace_all_uses_with(wait)
    graph.eliminate_dead_code()
    gm.recompile()


def _fold_written_views(gm) -> None:
    """Turn the in-place writes of a functionalized step into the values
    they write, as a program that returns updated copies computes them:

    * a read ``select(select_scatter(b, s, d, i), d, j)`` is ``s`` when
      ``j == i`` and ``select(b, d, j)`` otherwise; where the program took
      that view earlier and functionalize took it again at its first use
      (a block's cache slice, taken in ``layer<i>``, regenerated in
      ``layer<i>/sub<j>`` after an earlier block's write), the read is the
      program's view;
    * an output that writes every slot of a stacked input along dim 0
      (``select_scatter`` chains) is ``stack`` of the slot values, as
      ``jnp.stack`` of the per-layer caches;
    * the epilogue ``copy_`` of a written value into its input is dropped:
      the value is an output of the trace;
    * an ``index_copy`` at ``i[None]`` for a scalar ``i`` takes ``i``, the
      start ``dynamic_update_slice`` takes; where ``i`` is
      ``write_index(p, n)`` (``where(p < 0, p + n, p)`` clamped into the
      buffer), each write takes its own copy of the wrap and no clamp, as
      each ``lax.dynamic_update_slice_in_dim`` wraps its index and clamps
      inside the op.
    """
    graph = gm.graph
    sel, scat = _A.select.int, _A.select_scatter.default
    views = {}  # (base, dim, i) -> the first select of that slot
    for node in list(graph.nodes):
        if node.target is _A.index_copy.default:
            idx = node.args[2]
            if idx.target in (_A.unsqueeze.default, _A.view.default) and \
                    idx.args[0].meta["val"].dim() == 0:
                idx = _own_wrap(graph, node, idx.args[0])
                node.args = node.args[:2] + (idx,) + node.args[3:]
        if node.target is not sel:
            continue
        base, dim, i = node.args
        r, n = base.meta["val"].dim(), base.meta["val"].shape[dim]
        dim, i = dim % r, i % n
        while base.target is scat and base.args[2] % r == dim:
            if base.args[3] % n == i:
                node.replace_all_uses_with(base.args[1])
                break
            base = base.args[0]
        else:
            node.args = (base, dim, i)
            first = views.setdefault((base, dim, i), node)
            if first is not node and not first.users:
                # functionalize took the program's view again at its first
                # use: the view is the one the program took, in its scope
                node.replace_all_uses_with(first)
    out = next(n for n in graph.nodes if n.op == "output")

    def stacked(v):
        if not isinstance(v, torch.fx.Node) or v.target is not scat:
            return v
        slots, n = {}, v
        while n.target is scat and n.args[2] == 0:
            slots.setdefault(n.args[3] % n.meta["val"].shape[0], n.args[1])
            n = n.args[0]
        if n.op != "placeholder" or len(slots) != v.meta["val"].shape[0]:
            return v
        with graph.inserting_before(out):
            st = graph.call_function(_A.stack.default,
                                     ([slots[k] for k in range(len(slots))], 0))
        st.meta.update(val=v.meta["val"], stack_trace=v.meta.get("stack_trace"),
                       custom={"scope": ""})
        return st

    out.args = (torch.fx.node.map_aggregate(out.args[0], stacked),)
    for node in list(graph.nodes):
        if node.target is _A.copy_.default and node.args[0].op == "placeholder":
            graph.erase_node(node)
    graph.eliminate_dead_code()
    gm.recompile()


def _own_wrap(graph, user, idx):
    """``idx`` as ``user``'s own ``dynamic_update_slice`` start: for
    ``clamp(where(p < 0, p + n, p), 0, n - 1)`` over ``user``'s written dim
    of size ``n``, a copy of the ``where`` chain for ``user`` alone, in its
    scope and at its line (the op clamps); else ``idx``."""
    n = user.args[0].meta["val"].shape[user.args[1]]
    if idx.target is not _A.clamp.default or idx.args[1:] != (0, n - 1):
        return idx
    w = idx.args[0]
    if w.target is not _A.where.self:
        return idx
    lt, add, p = w.args
    if (lt.target is not _A.lt.Scalar or lt.args != (p, 0)
            or add.target is not _A.add.Tensor or add.args != (p, n)):
        return idx
    with graph.inserting_before(user):
        env = {p: p}
        for old in (lt, add, w):
            env[old] = graph.node_copy(old, lambda a: env[a])
            env[old].meta.update(custom=user.meta.get("custom"),
                                 stack_trace=user.meta.get("stack_trace"))
    return env[w]


def _leaf_shapes(args) -> tuple[list, Any]:
    leaves, treedef = tree_flatten(args)
    for leaf in leaves:
        if not hasattr(leaf, "shape") or not hasattr(leaf, "dtype"):
            raise TypeError(f"trace inputs must be tensors or ShapeDtype, got {leaf!r}")
    return leaves, treedef


def trace(
    fn: Callable,
    *args,
    layer_tag_fn: Callable[[str], Optional[int]] = default_layer_tag,
    name: str = "graph",
    grad: bool = False,
) -> tuple[Graph, list[int], list[int]]:
    """Trace ``fn(*args)`` to a TensorIR Graph.

    ``args`` are pytrees of tensors (real or fake) or :class:`ShapeDtype`s.
    Returns ``(graph, input_node_ids, output_node_ids)`` where input ids are
    in :func:`repro_torch.tree.tree_flatten` order (register sharding facts
    against these).  ``fn`` may write its inputs in place and return them
    (a serving step and its caches): it is traced functionalized, so what
    it writes is what its outputs compute.  ``grad``: ``fn`` differentiates
    with ``torch.autograd`` (the gradient path of :func:`_make_fx`).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    leaves, treedef = _leaf_shapes(args)
    fakes = _fake_inputs(FakeTensorMode(), leaves)

    def flat_fn(*flat):
        return tree_leaves(fn(*tree_unflatten(treedef, flat)))

    gm = _make_fx(flat_fn, fakes, grad)
    return _lower(gm, name, layer_tag_fn)


def local_shape(shape, spec, size, axis: str = "model") -> tuple:
    """The per-rank shape of a leaf whose dims ``spec`` shards: over
    ``axis`` of ``size`` ranks, or, with ``size`` a dict ``{axis: size}``,
    over every axis of a mesh (an entry may name several)."""
    sizes = size if isinstance(size, dict) else {axis: size}
    out = list(shape)
    for d, entry in enumerate(tuple(spec or ())):
        for a in entry if isinstance(entry, tuple) else (entry,):
            if a in sizes:
                if out[d] % sizes[a]:
                    raise ValueError(f"dim {d} of {tuple(shape)} is not divisible by "
                                     f"{a}={sizes[a]}")
                out[d] //= sizes[a]
    return tuple(out)


def trace_sharded(
    fn: Callable,
    size,
    in_specs,
    *args,
    axis: str = "model",
    layer_tag_fn: Callable[[str], Optional[int]] = default_layer_tag,
    name: str = "dist",
    grad: bool = False,
    ctx_kw: Optional[dict] = None,
) -> tuple[Graph, list[int], list[int]]:
    """Trace the **per-rank** program of a sharded function, with its
    collectives explicit.

    One axis: ``size`` ranks over ``axis``, and ``fn(ctx, *args)`` receives
    ``ParallelCtx.tensor_parallel`` over it, whose collectives run on the
    default group.  A mesh: ``size`` is an ordered ``{axis: size}`` (the
    JAX package's ``abstract_mesh(sizes, names)``), the fake process group
    holds their product with one subgroup per axis, and ``fn`` receives
    ``ParallelCtx.from_mesh`` over it (model axis ``"model"``, data axis
    ``"data"``, unless ``ctx_kw`` passes ``from_mesh`` others).  Each rank
    is a traced 0-d int64 input, emitted as ``axis_index`` over its axis; each collective carries the axis of the
    group it runs on.  ``args`` are *global* shapes; ``in_specs`` holds one
    spec tree per argument, and each input node carries the per-rank shape
    its spec gives over every axis.  In-place writes and ``grad`` as in
    :func:`trace`.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.parallel.sharding import is_spec

    mesh = size if isinstance(size, dict) else None
    sizes = mesh or {axis: size}
    leaves, treedef = _leaf_shapes(args)
    specs = tree_leaves(tuple(in_specs), is_leaf=is_spec)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} input specs for {len(leaves)} input leaves")
    local = [ShapeDtype(local_shape(leaf.shape, s, sizes), leaf.dtype)
             for leaf, s in zip(leaves, specs)]
    mode = FakeTensorMode()
    rank_axes = tuple(sizes)
    fakes = _fake_inputs(mode, [ShapeDtype((), torch.int64)] * len(rank_axes) + local)

    with fake_process_group(math.prod(sizes.values()), mesh) as dmesh:
        if dmesh is None:
            import torch.distributed as dist

            group_axes = {dist.distributed_c10d._get_default_group().group_name: axis}
        else:
            group_axes = {dmesh.get_group(a).group_name: a for a in rank_axes}

        def flat_fn(*flat):
            ranks, flat = flat[:len(rank_axes)], flat[len(rank_axes):]
            if dmesh is None:
                ctx = ParallelCtx.tensor_parallel(size, rank=ranks[0], axis=axis)
            else:
                ctx = ParallelCtx.from_mesh(dmesh, ranks=dict(zip(rank_axes, ranks)),
                                            **(ctx_kw or {}))
            return tree_leaves(fn(ctx, *tree_unflatten(treedef, flat)))

        gm = _make_fx(flat_fn, fakes, grad)
    return _lower(gm, name, layer_tag_fn, group_axes, rank_axes)
