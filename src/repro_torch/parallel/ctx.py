"""ParallelCtx: the single switch between single-device and SPMD execution.

Model code is written once against this facade.  With all axes ``None`` the
context is a no-op and the model is the single-device program.  With the
tensor-parallel axis set, the same code is the per-rank program of Megatron
TP: its collectives are ``torch.distributed``'s functional collective ops
(``torch.ops._c10d_functional``) on the context's process group, so the same
calls run on gloo or NCCL ranks and trace as explicit collective nodes under
the verifier's fake process group (``repro_torch.core.trace``).

The rank is a 0-d int64 tensor that the context holds (``rank``), never
``dist.get_rank()``: a trace would fold that Python int into a constant,
where the verifier needs the rank as a symbolic ``axis_index`` node.
Sequence parallelism (``sp``) replaces the psum after each row-parallel
region by a reduce_scatter along the sequence and gathers the sequence back
before each column-parallel region.

One axis alone (``tensor_parallel``, or the data axis set by itself) runs
its collectives on the default group, which holds every rank.  Over a
``DeviceMesh`` (``from_mesh``) the context keeps one process-group name and
one rank tensor per mesh axis: the model-axis collectives (``psum_tp``,
``gather_tp``, ``scatter_tp``, ``pmax_tp``, ``psum_ep``) run on the model
axis' group, ``psum_dp``/``pmean_dp`` on each data axis' group and
``psum_cp``/``pmax_cp`` on the context-parallel axis' group (a decode step
whose KV cache is cut along the sequence), so tp x dp and tp x cp run as
the JAX package's 2-D shard_map does.  ``pmax``, ``psum_scatter`` and
``all_gather`` run on any named axis (training's data-axis collectives).

Gradients flow through every collective as through JAX's transposes: a psum's
cotangent is psummed, an all_gather's is psum_scattered and a psum_scatter's
is all_gathered (the functional ops have no autograd formula of their own).
A value that autograd does not track takes the plain op, so the verifier's
traces are unchanged.  A max is never differentiated: callers detach first,
as JAX stops the gradient before ``pmax``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

import torch


# the collectives whose trace nodes take the line that calls them (the rank
# program's), as ``lax.psum`` called there does in JAX; the tracer reads
# this set, and every other collective keeps its line in this file
CALLER_LINE_CODES: set = set()


def _at_caller_line(fn):
    CALLER_LINE_CODES.add(fn.__code__)
    return fn


def _c10d():
    return torch.ops._c10d_functional


def _all_reduce(x, op: str, group: str):
    return _c10d().wait_tensor(_c10d().all_reduce(x.contiguous(), op, group))


def _gather0(x, n: int, group: str):
    """The ranks' ``x`` concatenated along dim 0, in rank order."""
    return _c10d().wait_tensor(_c10d().all_gather_into_tensor(x.contiguous(), n, group))


def _scatter0(x, n: int, group: str):
    """This rank's block of dim 0 of the ranks' sum of ``x``."""
    return _c10d().wait_tensor(_c10d().reduce_scatter_tensor(x.contiguous(), "sum", n,
                                                              group))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


class _Gather0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, group):
        ctx.n, ctx.group = n, group
        return _gather0(x, n, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter0(g, ctx.n, ctx.group), None, None


class _Scatter0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, group):
        ctx.n, ctx.group = n, group
        return _scatter0(x, n, group)

    @staticmethod
    def backward(ctx, g):
        return _gather0(g, ctx.n, ctx.group), None, None


def _tracked(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _applied(out):
    """The identity, seen by the verifier's tracer: a Function's autograd
    node is made after the ops of its forward, so the tracer takes this
    call to give the node the line, scope and count of the collective (its
    backward ops then take them), where a later op would give its own."""
    if torch.overrides.has_torch_function((out,)):
        return torch.overrides.handle_torch_function(_applied, (out,), out)
    return out


def psum_op(x, group: str):
    """All-reduce sum on ``group``, differentiable as ``lax.psum``."""
    return _applied(_Psum.apply(x, group)) if _tracked(x) else _all_reduce(x, "sum", group)


def gather0_op(x, n: int, group: str):
    """Dim-0 all_gather, differentiable (its transpose a reduce_scatter)."""
    return (_applied(_Gather0.apply(x, n, group)) if _tracked(x)
            else _gather0(x, n, group))


def scatter0_op(x, n: int, group: str):
    """Dim-0 reduce_scatter, differentiable (its transpose an all_gather)."""
    return (_applied(_Scatter0.apply(x, n, group)) if _tracked(x)
            else _scatter0(x, n, group))


def _via_host(fn, x):
    """``fn(x)`` on a CPU copy of a CUDA ``x``, moved back: gloo's CUDA
    all_gather did not finish in an earlier probe of the port, and gloo
    stages CUDA tensors through the host anyway."""
    if x.device.type == "cpu":
        return fn(x)
    return fn(x.cpu()).to(x.device)


@dataclass(frozen=True)
class ParallelCtx:
    tp_axis: Optional[str] = None
    dp_axis: Optional[str | tuple] = None
    ep_axis: Optional[str] = None
    cp_axis: Optional[str] = None
    tp_size: int = 1
    dp_size: int = 1
    ep_size: int = 1
    cp_size: int = 1
    dp_axis_sizes: tuple = ()  # per-axis sizes aligned with dp_axis tuple
    sp: bool = False  # sequence parallelism (activations seq-sharded over tp)
    # this rank's index along tp_axis, a 0-d int64 tensor; under the
    # verifier's tracer it is a traced input, emitted as ``axis_index``
    rank: Optional[torch.Tensor] = field(default=None, compare=False, repr=False)
    # over a mesh (``from_mesh``): every axis name in mesh order, with its
    # process-group name and this rank's index along it (0-d int64 tensors);
    # empty for one axis alone, whose collectives use the default group
    mesh_axes: tuple = ()
    groups: tuple = field(default=(), compare=False, repr=False)
    axis_ranks: tuple = field(default=(), compare=False, repr=False)

    @staticmethod
    def single() -> "ParallelCtx":
        return ParallelCtx()

    @staticmethod
    def from_mesh(mesh, tp: str = "model", dp="data", sp: bool = False,
                  cp: Optional[str] = None, ranks: Optional[dict] = None) -> "ParallelCtx":
        """The context of one rank of ``mesh`` (a ``DeviceMesh`` with
        ``mesh_dim_names``): ``tp`` names the model axis (experts share it),
        ``dp`` the data axis or a tuple of them; axes the mesh lacks are
        dropped, as in the JAX package.  ``ranks`` maps an axis to its rank
        tensor (the tracer's traced inputs); by default each is this
        process' coordinate along the axis, on the mesh's device."""
        names = tuple(mesh.mesh_dim_names)
        sizes = dict(zip(names, mesh.shape))
        dp_axes = dp if isinstance(dp, tuple) else (dp,) if dp else ()
        dp_axes = tuple(a for a in dp_axes if a in sizes)
        ranks = dict(ranks or {})
        for a in names:
            if a not in ranks:
                ranks[a] = torch.tensor(mesh.get_local_rank(a), dtype=torch.int64,
                                        device=mesh.device_type)
        has_tp = tp in sizes
        return ParallelCtx(
            tp_axis=tp if has_tp else None,
            dp_axis=dp_axes or None,
            ep_axis=tp if has_tp else None,
            cp_axis=cp if cp in sizes else None,
            tp_size=sizes.get(tp, 1),
            dp_size=math.prod(sizes[a] for a in dp_axes),
            ep_size=sizes.get(tp, 1),
            cp_size=sizes.get(cp, 1),
            dp_axis_sizes=tuple(sizes[a] for a in dp_axes),
            sp=sp,
            rank=ranks[tp] if has_tp else None,
            mesh_axes=names,
            groups=tuple(mesh.get_group(a).group_name for a in names),
            axis_ranks=tuple(ranks[a] for a in names),
        )

    @staticmethod
    def tensor_parallel(size: int, rank: Optional[torch.Tensor] = None,
                        axis: str = "model", sp: bool = False) -> "ParallelCtx":
        """Megatron TP over ``axis`` (experts, when there are any, over the
        same axis, as ``ParallelCtx.from_mesh`` sets it in the JAX package),
        sequence-parallel with ``sp``."""
        return ParallelCtx(tp_axis=axis, tp_size=size, ep_axis=axis, ep_size=size,
                           sp=sp, rank=rank)

    def with_rank(self, rank: torch.Tensor) -> "ParallelCtx":
        return replace(self, rank=rank)

    @property
    def distributed(self) -> bool:
        return (self.tp_axis is not None or self.dp_axis is not None
                or self.cp_axis is not None)

    def axis_group(self, axis: str) -> str:
        """The name of ``axis``' process group, as the functional collective
        ops take it: the mesh's group for the axis, or, with one axis alone
        (no mesh), the default group, which holds every rank."""
        if self.mesh_axes:
            return self.groups[self.mesh_axes.index(axis)]
        import torch.distributed as dist

        return dist.distributed_c10d._get_default_group().group_name

    def axis_index(self, axis: str):
        """This rank's index along a mesh axis (a 0-d int64 tensor)."""
        return self.axis_ranks[self.mesh_axes.index(axis)]

    def axis_size(self, axis: str) -> int:
        if axis == self.tp_axis:
            return self.tp_size
        if axis == self.cp_axis:
            return self.cp_size
        axes = self.dp_axis if isinstance(self.dp_axis, tuple) else (self.dp_axis,)
        if axis in axes and self.dp_axis_sizes:
            return self.dp_axis_sizes[axes.index(axis)]
        if axis in axes:
            return self.dp_size
        raise ValueError(f"{axis!r} is not an axis of this context")

    def dp_index(self):
        """This rank's index along the data axes, linearized in mesh order
        (``lax.axis_index`` over the tuple of data axes; 0 without one)."""
        if not self.dp_axis:
            return 0
        axes = self.dp_axis if isinstance(self.dp_axis, tuple) else (self.dp_axis,)
        idx = 0
        for a in axes:
            idx = idx * self.axis_size(a) + self.axis_index(a)
        return idx

    def _group(self) -> str:
        return self.axis_group(self.tp_axis)

    def psum(self, x, axis: str):
        """``lax.psum`` over one mesh axis (the pipeline's stage axis, a data
        axis)."""
        return psum_op(x, self.axis_group(axis))

    def pmax(self, x, axis: str):
        """``lax.pmax`` over one mesh axis, of a value autograd does not
        track."""
        return _all_reduce(x, "max", self.axis_group(axis))

    def psum_scatter(self, x, axis: str, dim: int):
        """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
        the sum over the axis' ranks, cut along ``dim`` into its size in
        blocks, this rank's block kept.  A CUDA tensor goes through the
        host."""
        n, group, dim = self.axis_size(axis), self.axis_group(axis), dim % x.ndim

        def run(t):
            if dim:
                t = torch.cat(torch.chunk(t, n, dim=dim))
            return scatter0_op(t, n, group)
        return _via_host(run, x)

    def all_gather(self, x, axis: str, dim: int):
        """``lax.all_gather(x, axis, axis=dim, tiled=True)``: the axis'
        ranks' blocks concatenated along ``dim`` in rank order.  A CUDA
        tensor goes through the host."""
        n, group, dim = self.axis_size(axis), self.axis_group(axis), dim % x.ndim

        def run(t):
            y = gather0_op(t, n, group)
            return torch.cat(torch.chunk(y, n, dim=0), dim=dim) if dim else y
        return _via_host(run, x)

    def _all_reduce(self, x, op: str, group: Optional[str] = None):
        group = group or self._group()
        return psum_op(x, group) if op == "sum" else _all_reduce(x, op, group)

    # -- tensor-parallel collectives -----------------------------------------
    def psum_tp(self, x):
        """Discharge a row-parallel partial sum (Megatron g-bar)."""
        return self._all_reduce(x, "sum") if self.tp_axis else x

    def pmax_tp(self, x):
        """The max over the model axis, of a value autograd does not track."""
        return self._all_reduce(x, "max") if self.tp_axis else x

    def gather_tp(self, x, axis: int):
        """Tiled all_gather along ``axis``: the dim-0 functional collective,
        then the rank blocks moved to ``axis`` (chunk + cat, which the
        verifier's tracer folds back into one all_gather along ``axis``)."""
        return self.all_gather(x, self.tp_axis, axis) if self.tp_axis else x

    def scatter_tp(self, x, axis: int):
        """reduce_scatter along ``axis``: partial-sum in, shard out (the rank
        blocks of ``axis`` moved to dim 0 first, for the dim-0 functional
        collective; the tracer folds this back as in ``gather_tp``)."""
        return self.psum_scatter(x, self.tp_axis, axis) if self.tp_axis else x

    def tp_index(self):
        if not self.tp_axis:
            return 0
        if self.rank is None:
            raise ValueError("a tensor-parallel ParallelCtx needs its rank tensor "
                             "(ParallelCtx.with_rank)")
        return self.rank

    # -- expert-parallel -------------------------------------------------------
    def psum_ep(self, x):
        """Discharge the experts' partial sum over the expert axis."""
        return self._all_reduce(x, "sum") if self.ep_axis else x

    def ep_index(self):
        """This rank's index along the expert axis (0 without one): the
        rank tensor, which is the tensor-parallel rank where experts share
        the model axis."""
        if not self.ep_axis:
            return 0
        if self.rank is None:
            raise ValueError("an expert-parallel ParallelCtx needs its rank tensor "
                             "(ParallelCtx.with_rank)")
        return self.rank

    # -- sequence-parallel region helpers ------------------------------------
    def sp_enter(self, x, seq_axis: int = 1):
        """Row-parallel output -> the next region's input.  SP on: a
        reduce_scatter along the sequence.  SP off: a plain psum."""
        if not self.tp_axis:
            return x
        if self.sp:
            return self.scatter_tp(x, seq_axis)
        return self.psum_tp(x)

    def sp_exit(self, x, seq_axis: int = 1):
        """Sequence-sharded activation -> the replicated input of a
        column-parallel region.  SP on: an all_gather along the sequence.
        SP off: identity."""
        if self.tp_axis and self.sp:
            return self.gather_tp(x, seq_axis)
        return x

    # -- data-parallel -------------------------------------------------------
    @_at_caller_line
    def psum_dp(self, x):
        """``lax.psum`` over the data axes: one all_reduce on each axis'
        group (their product's sum)."""
        if not self.dp_axis:
            return x
        axes = self.dp_axis if isinstance(self.dp_axis, tuple) else (self.dp_axis,)
        for a in axes:
            x = self._all_reduce(x, "sum", self.axis_group(a))
        return x

    def pmean_dp(self, x):
        """``lax.pmean``: the psum over the data axis, divided by its size."""
        return self.psum_dp(x) / self.dp_size if self.dp_axis else x

    # -- context parallel (flash decode over a sequence-cut KV cache) --------
    def cp_index(self):
        """This rank's index along the context-parallel axis: its rank
        tensor, as every axis' (0 without one)."""
        return self.axis_index(self.cp_axis) if self.cp_axis else 0

    def psum_cp(self, x):
        """``lax.psum`` over the context-parallel axis."""
        return self.psum(x, self.cp_axis) if self.cp_axis else x

    def pmax_cp(self, x):
        """``lax.pmax`` over the context-parallel axis, of a value autograd
        does not track."""
        return self.pmax(x, self.cp_axis) if self.cp_axis else x
