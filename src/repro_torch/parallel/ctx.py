"""ParallelCtx: the single switch between single-device and SPMD execution.

Model code is written once against this facade.  With all axes ``None`` the
context is a no-op and the model is the single-device program.  With the
tensor-parallel axis set, the same code is the per-rank program of Megatron
TP: its collectives are ``torch.distributed._functional_collectives`` calls
on the context's process group, so the same calls run on gloo or NCCL ranks
and trace as explicit collective nodes under the verifier's fake process
group (``repro_torch.core.trace``).

The rank is a 0-d int64 tensor that the context holds (``rank``), never
``dist.get_rank()``: a trace would fold that Python int into a constant,
where the verifier needs the rank as a symbolic ``axis_index`` node.
Sequence parallelism and the data and context-parallel axes are not ported
yet: each raises ``NotImplementedError`` when it is switched on.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import torch


def _unported(what) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


def _funcol():
    import torch.distributed._functional_collectives as funcol

    return funcol


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

    @staticmethod
    def single() -> "ParallelCtx":
        return ParallelCtx()

    @staticmethod
    def tensor_parallel(size: int, rank: Optional[torch.Tensor] = None,
                        axis: str = "model") -> "ParallelCtx":
        """Megatron TP over ``axis`` (experts, when there are any, over the
        same axis, as ``ParallelCtx.from_mesh`` sets it in the JAX package)."""
        return ParallelCtx(tp_axis=axis, tp_size=size, ep_axis=axis, ep_size=size,
                           rank=rank)

    def with_rank(self, rank: torch.Tensor) -> "ParallelCtx":
        return replace(self, rank=rank)

    @property
    def distributed(self) -> bool:
        return self.tp_axis is not None or self.dp_axis is not None

    def _group(self):
        """The tp axis' process group: the default group, which holds every
        rank while tp is the only axis that runs."""
        import torch.distributed as dist

        return dist.group.WORLD

    # -- tensor-parallel collectives -----------------------------------------
    def psum_tp(self, x):
        """Discharge a row-parallel partial sum (Megatron g-bar)."""
        return _funcol().all_reduce(x, "sum", self._group()) if self.tp_axis else x

    def pmax_tp(self, x):
        return _funcol().all_reduce(x, "max", self._group()) if self.tp_axis else x

    def gather_tp(self, x, axis: int):
        """all_gather_into_tensor along dim 0, then the tiled move to ``axis``."""
        if not self.tp_axis:
            return x
        return _funcol().all_gather_tensor(x, axis % x.ndim, self._group())

    def scatter_tp(self, x, axis: int):
        """reduce_scatter: partial-sum in, shard out."""
        if not self.tp_axis:
            return x
        return _funcol().reduce_scatter_tensor(x, "sum", axis % x.ndim, self._group())

    def tp_index(self):
        if not self.tp_axis:
            return 0
        if self.rank is None:
            raise ValueError("a tensor-parallel ParallelCtx needs its rank tensor "
                             "(ParallelCtx.with_rank)")
        return self.rank

    # -- sequence-parallel region helpers ------------------------------------
    def sp_enter(self, x, seq_axis: int = 1):
        """Row-parallel output -> the next region's input: a plain psum (the
        reduce_scatter of sequence parallelism is not ported yet)."""
        if not self.tp_axis:
            return x
        if self.sp:
            raise _unported("sequence parallelism")
        return self.psum_tp(x)

    def sp_exit(self, x, seq_axis: int = 1):
        if self.tp_axis and self.sp:
            raise _unported("sequence parallelism")
        return x

    # -- data-parallel -------------------------------------------------------
    def psum_dp(self, x):
        if self.dp_axis:
            raise _unported(f"data parallelism over {self.dp_axis!r}")
        return x

    def pmean_dp(self, x):
        if self.dp_axis:
            raise _unported(f"data parallelism over {self.dp_axis!r}")
        return x

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
