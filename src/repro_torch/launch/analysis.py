"""Roofline terms for dry-run cells, under an H100 hardware model.

The counts come from one source: the port's TensorIR trace of the per-rank
program, made in count mode (:func:`repro_torch.scope.counting`: each of
the microbatch, layer, attention-chunk and SSD-chunk loops traced once,
each node carrying ``mult``, the trip counts of the loops around it), the
counterpart of the JAX package's ``trace(..., scan_inline=True)``.  From it:
exact per-device collective wire bytes, analytic dot FLOPs, and HBM traffic
under a first-order fusion model.  (The JAX package also records XLA's
``cost_analysis()``/``memory_analysis()`` as a per-iteration cross-check;
torch has no compiled counterpart, and the IR is the reference's
authoritative source too.)

Hardware model, one NVIDIA H100 SXM5 80 GB (the card ``chip_smoke.py``
runs on), from NVIDIA's H100 datasheet and the DGX H100 system:
  PEAK_FLOPS = 989e12  dense BF16 tensor-core FLOP/s (1979e12 is the
                       2:4-sparse figure; dense is half of it)
  PEAK_FLOPS_F32 = 67e12  FP32 FLOP/s without tensor cores (the
                       kernels' f32 bounds; the roofline takes bf16's)
  HBM_BW     = 3.35e12 HBM3 bytes/s
  NVLINK_BW  = 450e9   NVLink 4, bytes/s a direction a GPU (900e9 both
                       ways), for an axis whose group fits in one node
  IB_BW      = 50e9    NDR InfiniBand, 400 Gb/s a GPU (one ConnectX-7
                       per GPU in a DGX H100), for a wider or outer axis
  NODE_GPUS  = 8       GPUs a node, all joined by NVLink (HGX/DGX H100)
Ring collectives, per device on the wire (n ranks in the group):
  all_reduce P bytes    -> 2 * P * (n-1)/n
  all_gather/reduce_scatter of full size G -> G * (n-1)/n
  all_to_all I          -> I * (n-1)/n
A collective's bytes go at NVLINK_BW when its group lies inside one node
(the product of its axis and every axis inside it in the mesh is at most
NODE_GPUS: "model" of a ("data", "model") mesh of 16 ranks an axis does
not), else at IB_BW.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

from repro_torch.core.ir import COLLECTIVES

PEAK_FLOPS = 989e12  # dense bf16 FLOP/s a GPU
PEAK_FLOPS_F32 = 67e12  # f32 FLOP/s a GPU, no tensor cores
HBM_BW = 3.35e12  # bytes/s a GPU
NVLINK_BW = 450e9  # bytes/s a direction a GPU, inside a node
IB_BW = 50e9  # bytes/s a GPU, across nodes
NODE_GPUS = 8

_DTYPE_BYTES = {
    "float32": 4, "f32": 4, "bfloat16": 2, "bf16": 2, "float16": 2,
    "int32": 4, "s32": 4, "int8": 1, "s8": 1, "uint8": 1, "bool": 1,
    "int64": 8, "float64": 8, "pred": 1, "uint32": 4, "int16": 2,
}


def dtype_bytes(dt: str) -> int:
    return _DTYPE_BYTES.get(str(dt), 4)


@dataclass
class CollectiveRecord:
    op: str
    axes: tuple
    n: int
    shape: tuple
    dtype: str
    mult: int
    payload_bytes: int
    wire_bytes: int


def _axis_product(axes, mesh_sizes: dict) -> int:
    n = 1
    for a in axes or ():
        n *= mesh_sizes.get(a, 1)
    return n


def link_bw(axes, mesh_sizes: dict) -> float:
    """The wire rate of a collective over ``axes`` of a mesh whose axes
    ``mesh_sizes`` lists outermost first: NVLink when the ranks it spans
    (its axes and every axis inside them) fit in one node, else
    InfiniBand."""
    names = list(mesh_sizes)
    if not axes or not names:
        return NVLINK_BW
    outer = min(names.index(a) for a in axes if a in names)
    span = _axis_product(names[outer:], mesh_sizes)
    return NVLINK_BW if span <= NODE_GPUS else IB_BW


# ops whose outputs are materialized to HBM in the first-order fusion model
# (elementwise/layout chains are assumed fused into their consumers)
_MATERIALIZE = frozenset(
    "dot conv reduce_sum reduce_max reduce_min reduce_prod all_reduce all_gather "
    "reduce_scatter all_to_all ppermute concat gather scatter scatter_add sort "
    "top_k cumsum dynamic_update_slice dynamic_slice".split()
)

# the regions a hand kernel computes on the card (``chunked_attention``'s
# and ``ssd_chunked``'s named scopes): their internals stay on chip
_KERNEL_SCOPES = ("flash_attn", "ssd_kernel")


def ir_stats(g, mesh_sizes: dict) -> dict:
    """Collectives, FLOPs and HBM traffic of a traced graph, each node
    counted ``mult`` times."""
    colls: list[CollectiveRecord] = []
    dot_flops = 0
    ew_flops = 0
    hbm_bytes = 0
    kernel_hbm_bytes = 0  # traffic the kernels keep on chip
    coll_s = 0.0

    def in_kernel(node) -> bool:
        return any(k in node.scope for k in _KERNEL_SCOPES)

    for node in g:
        mult = node.param("mult", 1) or 1
        nbytes = node.size * dtype_bytes(node.dtype)
        if node.op in _MATERIALIZE:
            in_bytes = sum(g[i].size * dtype_bytes(g[i].dtype) for i in node.inputs)
            hbm_bytes += (nbytes + in_bytes) * mult
            if in_kernel(node):
                # on the kernel path these stay in shared memory or
                # registers, except the kernel's inputs read from HBM and
                # the outputs written back
                ext_in = sum(g[i].size * dtype_bytes(g[i].dtype)
                             for i in node.inputs
                             if not in_kernel(g[i]) and g[i].op != "const")
                escapes = any(not in_kernel(g[c]) for c in g.consumers(node.id))
                kernel_hbm_bytes += (nbytes + in_bytes - ext_in
                                     - (nbytes if escapes else 0)) * mult
        elif node.op in ("input", "param", "const"):
            pass
        else:
            ew_flops += node.size * mult
        if node.op in COLLECTIVES:
            axes = node.param("axes") or ()
            n = _axis_product(axes, mesh_sizes)
            if n <= 1:
                continue
            if node.op == "all_gather":
                payload = node.size * dtype_bytes(node.dtype)  # gathered size
                wire = payload * (n - 1) // n
            elif node.op in ("reduce_scatter", "all_to_all"):
                src = g[node.inputs[0]]
                payload = src.size * dtype_bytes(src.dtype)
                wire = payload * (n - 1) // n
            elif node.op == "ppermute":
                payload = node.size * dtype_bytes(node.dtype)
                wire = payload
            else:  # all_reduce
                payload = node.size * dtype_bytes(node.dtype)
                wire = 2 * payload * (n - 1) // n
            colls.append(CollectiveRecord(node.op, tuple(axes), n, tuple(node.shape),
                                          node.dtype, mult, payload * mult, wire * mult))
            coll_s += wire * mult / link_bw(axes, mesh_sizes)
        elif node.op == "dot":
            dn = node.param("dimension_numbers")
            if dn is None:
                continue
            (lc, _), _ = dn
            lhs = g[node.inputs[0]]
            k = 1
            for d in lc:
                k *= lhs.shape[d]
            dot_flops += 2 * node.size * k * mult
    return {
        "collectives": [asdict(c) for c in colls],
        "collective_wire_bytes": sum(c.wire_bytes for c in colls),
        "collective_payload_bytes": sum(c.payload_bytes for c in colls),
        "collective_s": coll_s,
        "ir_dot_flops": dot_flops,
        "ir_ew_flops": ew_flops,
        "ir_hbm_bytes": hbm_bytes,
        "ir_kernel_saved_bytes": kernel_hbm_bytes,
        "ir_nodes": len(g.nodes),
    }


def sum_ir_stats(parts: list) -> dict:
    """The counts of a program traced in several pieces, added up."""
    out = {k: sum(p[k] for p in parts) for k in parts[0] if k != "collectives"}
    out["collectives"] = [c for p in parts for c in p["collectives"]]
    return out


def collect_ir_stats(fn, avals, mesh_sizes: dict, in_specs=None, *,
                     grad: bool = False, ctx_kw=None) -> dict:
    """Trace ``fn`` in count mode and account its collectives, FLOPs and
    HBM traffic.  With ``in_specs``, ``fn(ctx, *avals)`` is the per-rank
    program over a mesh of ``mesh_sizes`` (:func:`trace_sharded` under the
    fake process group; ``avals`` are global shapes); without, ``fn(*avals)``
    is a one-device program.  ``grad``: ``fn`` differentiates; ``ctx_kw``:
    the keywords of the rank's ``ParallelCtx.from_mesh``."""
    from repro_torch.core.trace import trace, trace_sharded
    from repro_torch.scope import counting

    with counting():
        if in_specs is None:
            g, _, _ = trace(fn, *avals, grad=grad, name="dryrun")
        else:
            g, _, _ = trace_sharded(fn, dict(mesh_sizes), in_specs, *avals, grad=grad,
                                    name="dryrun", ctx_kw=ctx_kw)
    return ir_stats(g, mesh_sizes)


def roofline_terms(ir: dict, *, model_flops_per_device: float) -> dict:
    """The three roofline terms in seconds, the dominant one, and the
    usefulness ratio, from the trip-count-exact IR counts."""
    flops = float(ir["ir_dot_flops"] + ir["ir_ew_flops"])
    hbm = float(ir["ir_hbm_bytes"])
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm / HBM_BW
    t_coll = float(ir["collective_s"])
    # the memory term with the hand kernels swapped in (attention and SSD
    # internals stay on chip; the trace lowers the reference paths)
    t_memory_kernel = max(hbm - float(ir.get("ir_kernel_saved_bytes", 0.0)), 0.0) / HBM_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    total = max(t_compute, t_memory, t_coll)
    bound_kernel = max(t_compute, t_memory_kernel, t_coll)
    return {
        **terms,
        "memory_s_pallas": t_memory_kernel,
        "bound_s": total,
        "bound_s_pallas": bound_kernel,
        "roofline_fraction_pallas": ((model_flops_per_device / PEAK_FLOPS) / bound_kernel
                                     if bound_kernel else None),
        "dominant": dominant,
        "ir_flops": flops,
        "ir_hbm_bytes": hbm,
        "model_flops_per_device": model_flops_per_device,
        "useful_flop_ratio": (model_flops_per_device / flops) if flops else None,
        "roofline_fraction": (model_flops_per_device / PEAK_FLOPS) / total if total else None,
    }
