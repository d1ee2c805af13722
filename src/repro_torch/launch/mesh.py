"""Mesh construction: ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the running process group.

Functions, never module-level constants, so importing this module touches
no process group.  Each needs a default process group of exactly the
mesh's size (gloo ranks from ``parallel.spmd``, or the verifier's fake
process group), and every rank must call it in the same order: a
``DeviceMesh`` creates one process group per axis, collectively.
"""
from __future__ import annotations


def make_mesh(shape: tuple, names: tuple, device_type: str = "cuda"):
    """A mesh of ``shape`` with axes ``names`` (``jax.make_mesh``'s
    counterpart) over the running ranks, in rank order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a default process group of its size "
                           "(parallel.spmd.run, or the tracer's fake process group)")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def production_mesh_sizes(*, multi_pod: bool = False) -> dict:
    """The production mesh as an ordered ``{axis: size}``: 16x16 single-pod
    (256 ranks) or 2x16x16 multi-pod (512 ranks).  Axes: ("data", "model") /
    ("pod", "data", "model").  DP runs over pod+data, TP/EP over model."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh (:func:`production_mesh_sizes`) over the running
    ranks."""
    sizes = production_mesh_sizes(multi_pod=multi_pod)
    return make_mesh(tuple(sizes.values()), tuple(sizes), device_type)


def make_debug_mesh(tp: int = 2, dp: int = 1, device_type: str = "cuda"):
    """A (dp, tp) mesh named ("data", "model") over the running ranks."""
    return make_mesh((dp, tp), ("data", "model"), device_type)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh, a ``DeviceMesh`` or an ordered
    ``{axis: size}`` (pod folds into DP)."""
    names = mesh if isinstance(mesh, dict) else mesh.mesh_dim_names
    return tuple(a for a in names if a in ("pod", "data"))
