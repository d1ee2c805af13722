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
axis' group and ``psum_dp``/``pmean_dp`` on each data axis' group, so tp x
dp runs as the JAX package's 2-D shard_map does.  The context-parallel axis
raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

import torch


def _unported(what) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


def _c10d():
    return torch.ops._c10d_functional


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
        return self.tp_axis is not None or self.dp_axis is not None

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

    def _group(self) -> str:
        return self.axis_group(self.tp_axis)

    def psum(self, x, axis: str):
        """``lax.psum`` over one mesh axis (the pipeline's stage axis)."""
        return self._all_reduce(x, "sum", self.axis_group(axis))

    def _all_reduce(self, x, op: str, group: Optional[str] = None):
        return _c10d().wait_tensor(_c10d().all_reduce(
            x.contiguous(), op, group or self._group()))

    # -- tensor-parallel collectives -----------------------------------------
    def psum_tp(self, x):
        """Discharge a row-parallel partial sum (Megatron g-bar)."""
        return self._all_reduce(x, "sum") if self.tp_axis else x

    def pmax_tp(self, x):
        return self._all_reduce(x, "max") if self.tp_axis else x

    def gather_tp(self, x, axis: int):
        """Tiled all_gather along ``axis``: the dim-0 functional collective,
        then the rank blocks moved to ``axis`` (chunk + cat, which the
        verifier's tracer folds back into one all_gather along ``axis``)."""
        if not self.tp_axis:
            return x
        y = _c10d().wait_tensor(_c10d().all_gather_into_tensor(
            x.contiguous(), self.tp_size, self._group()))
        axis %= x.ndim
        return torch.cat(torch.chunk(y, self.tp_size, dim=0), dim=axis) if axis else y

    def scatter_tp(self, x, axis: int):
        """reduce_scatter along ``axis``: partial-sum in, shard out (the rank
        blocks of ``axis`` moved to dim 0 first, for the dim-0 functional
        collective; the tracer folds this back as in ``gather_tp``)."""
        if not self.tp_axis:
            return x
        axis %= x.ndim
        if axis:
            x = torch.cat(torch.chunk(x, self.tp_size, dim=axis))
        return _c10d().wait_tensor(_c10d().reduce_scatter_tensor(
            x.contiguous(), "sum", self.tp_size, self._group()))

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

    # -- context parallel ----------------------------------------------------
    def cp_index(self):
        if self.cp_axis:
            raise _unported(f"context parallelism over {self.cp_axis!r}")
        return 0

    def psum_cp(self, x):
        if self.cp_axis:
            raise _unported(f"context parallelism over {self.cp_axis!r}")
        return x

    def pmax_cp(self, x):
        if self.cp_axis:
            raise _unported(f"context parallelism over {self.cp_axis!r}")
        return x
