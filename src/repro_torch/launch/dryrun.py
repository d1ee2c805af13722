"""Multi-pod dry run: size a model on a production mesh before any card time
is spent.

For one (architecture x input shape x mesh) cell: build the per-rank step
function (the train step, the prefill forward or the decode step, with its
collectives explicit), trace it under a fake process group over the
production mesh with fake tensors (nothing is allocated), and record per
device: memory (argument and output bytes, and the peak that
``torch.distributed._tools.mem_tracker.MemTracker`` estimates over one
eager run under ``FakeTensorMode``), collective wire bytes, and the roofline
terms under the H100 hardware model of :mod:`repro_torch.launch.analysis`.
The counts come from a trace in count mode (:func:`repro_torch.scope.counting`):
the microbatch, layer and chunk loops traced once, each op counted as often
as the loop runs it, as the JAX package's ``scan_inline`` trace counts its
scans.  Each cell's result is written as JSON under ``artifacts/dryrun_torch``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_4b --shape train_4k
  python -m repro_torch.launch.dryrun --arch jamba_1_5_large --shape long_500k --multi-pod
  python -m repro_torch.launch.dryrun --arch llama3_405b --shape decode_32k --gather-weights
  python -m repro_torch.launch.dryrun --all            # one subprocess per cell
Options: --zero1 --sp --micro N --compress {none,bf16,int8} --pure-dp --out DIR
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch

from repro_torch.configs.base import (ARCH_IDS, EXTRA_IDS, SHAPES, ShapeDtype, get_config,
                                      input_specs, skip_reason)
from repro_torch.launch import analysis
from repro_torch.launch.mesh import dp_axes, production_mesh_sizes
from repro_torch.parallel.sharding import (P, batch_spec, cache_specs, is_spec,
                                           param_specs)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def _f32_like(spec_tree):
    return tree_map(lambda s: ShapeDtype(tuple(s.shape), torch.float32), spec_tree)


def _zip_map(fn, tree, *others):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``others`` (PartitionSpecs and ints are leaves), in ``tree``'s shape."""
    leaves, treedef = tree_flatten(tree, is_leaf=is_spec)
    rest = [tree_flatten(o, is_leaf=is_spec)[0] for o in others]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *rest)])


def _opt_specs(pspecs, *, zero1: bool, dp_last: str | None, flags=None):
    """Optimizer-moment PartitionSpecs: same as params; with ZeRO-1 the shard
    dim per leaf (from _zero_flags_from_specs; -1 = replicated) additionally
    shards over the given axis."""

    def visit(spec, dim):
        if not zero1 or dp_last is None or dim is None or dim < 0:
            return spec
        entries = list(tuple(spec))
        entries += [None] * (dim + 1 - len(entries))
        entries[dim] = dp_last
        return P(*entries)

    if flags is None:
        flags = tree_map(lambda _: 0, pspecs, is_leaf=is_spec)
    m = _zip_map(visit, pspecs, flags)
    return {"m": m, "v": m, "step": P()}


def _zero_flags_from_specs(param_shapes, dp_size: int, pspecs):
    """Per-leaf ZeRO shard dim: the first dim that is spec-unsharded and
    divisible by the shard group size (-1 = keep replicated)."""

    def visit(s, spec):
        entries = tuple(spec)
        for i, size in enumerate(s.shape):
            e = entries[i] if i < len(entries) else None
            if e is None and size % dp_size == 0 and size >= dp_size:
                return i
        return -1

    return _zip_map(visit, param_shapes, pspecs)


def _zero_opt_shapes(param_shapes):
    # global view: moments keep full shape; sharding comes from specs
    m = _f32_like(param_shapes)
    return {"m": m, "v": m, "step": ShapeDtype((), torch.int32)}


def _weight_gather_plan(param_shapes, pspecs, dp: int):
    """Per-block-position trees of gather dims for 2D-sharded serving
    weights: the first spec-None dim (excluding the stacked nb dim 0) whose
    size divides dp gets the extra 'data' sharding; -1 = stay resident."""

    def visit(s, spec):
        entries = tuple(spec)
        for i in range(1, len(s.shape)):  # skip the stacked nb dim
            e = entries[i] if i < len(entries) else None
            if e is None and s.shape[i] % dp == 0 and s.shape[i] >= dp * 8:
                return i - 1  # dim index after the per-layer slice drops nb
        return -1

    return tuple(_zip_map(visit, b, s)
                 for b, s in zip(param_shapes["blocks"], pspecs["blocks"]))


def _apply_gather_specs(pspecs, param_shapes, plan, dp_axis="data"):
    """Insert the extra 'data' entry into block param specs per the plan."""

    def visit(spec, s, dim):
        if dim is None or dim < 0:
            return spec
        entries = list(tuple(spec)) + [None] * (len(s.shape) - len(tuple(spec)))
        entries[dim + 1] = dp_axis  # +1: stacked nb dim precedes
        return P(*entries)

    out = dict(pspecs)
    out["blocks"] = tuple(_zip_map(visit, pspecs["blocks"][j], param_shapes["blocks"][j],
                                   plan[j]) for j in range(len(plan)))
    return out


@dataclass
class Phase:
    """A traced piece of a cell's per-rank program: ``fn(ctx, *avals)``,
    its inputs' global shapes and specs, and whether it differentiates."""

    fn: Callable
    avals: tuple
    in_specs: tuple
    grad: bool = False


@dataclass
class Cell:
    """One cell's per-rank program over a mesh of ``sizes``: ``step`` (the
    whole program, run for its memory) and the ``phases`` it is traced in
    (the train step's gradients with autograd, its in-place update
    functionalized), and the keywords of the rank's
    ``ParallelCtx.from_mesh``."""

    step: Phase
    phases: list
    sizes: dict
    ctx_kw: dict


def build_cell(arch: str, shape: str, mesh: dict, *, zero1=False, sp=False, micro=0,
               compress="none", gather_weights=False, pure_dp=False) -> Cell:
    """The per-rank step of ``arch`` at ``shape`` on ``mesh`` (an ordered
    ``{axis: size}``)."""
    from repro_torch.models import Model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, make_step_fn, step_phases

    cfg = get_config(arch)
    spec = SHAPES[shape]
    sizes = dict(mesh)
    dp = dp_axes(sizes) + (("model",) if pure_dp else ())
    dp_total = math.prod(sizes[a] for a in dp)

    batch_shardable = spec.global_batch % dp_total == 0 and spec.global_batch >= dp_total
    if pure_dp and not batch_shardable:
        raise ValueError(
            f"--pure-dp needs global_batch ({spec.global_batch}) divisible by and >= "
            f"the chip count ({dp_total}); use the hybrid TP x DP layout instead")
    dp_entry = dp if batch_shardable else None
    use_cp = shape == "long_500k" and cfg.attn_period > 0  # hybrid flash-decode
    # beyond-paper resharding with --pure-dp: the whole mesh data-parallel
    # (small models waste TP wire), params replicated, ZeRO-1 sharding the
    # optimizer state over the innermost axis
    ctx_kw = (dict(tp=None, dp=dp_entry) if pure_dp else
              dict(dp=dp_entry, sp=sp, cp="data" if use_cp else None))
    param_shapes = Model(cfg, impl="reference", device="cpu").param_shapes()
    pspecs = param_specs(param_shapes)
    if pure_dp:
        pspecs = tree_map(lambda s: P(*([None] * len(s.shape))), param_shapes)
    batch = input_specs(cfg, shape)
    bspecs = batch_spec(batch, dp_entry)

    def model(ctx, **kw):
        return Model(cfg, ctx, impl="reference", device="cpu", **kw)

    if spec.kind == "train":
        if micro <= 0:
            micro = max(1, spec.global_batch // dp_total // 2)
        tcfg = TrainConfig(opt=AdamWConfig(), microbatches=micro, remat=True,
                           zero1=zero1, grad_compress=compress)
        zero_axis_size = sizes.get("model", 1) if pure_dp else sizes.get("data", 1)
        flags = _zero_flags_from_specs(param_shapes, zero_axis_size, pspecs) if zero1 else None
        opt_shapes = (_zero_opt_shapes(param_shapes) if zero1 else
                      {"m": _f32_like(param_shapes), "v": _f32_like(param_shapes),
                       "step": ShapeDtype((), torch.int32)})
        zero_axis = ("model" if pure_dp else "data") if zero1 else None
        ospecs = _opt_specs(pspecs, zero1=zero1, dp_last=zero_axis, flags=flags)

        def fn(ctx, params, opt, b):
            return make_step_fn(model(ctx), tcfg, shard_flags=flags)(params, opt, b)

        def grads_fn(ctx, params, b):
            return step_phases(model(ctx), tcfg, shard_flags=flags)[0](params, b)

        def update_fn(ctx, params, grads, opt, loss):
            return step_phases(model(ctx), tcfg, shard_flags=flags)[1](params, grads, opt,
                                                                        loss)

        loss = ShapeDtype((), torch.float32)
        return Cell(Phase(fn, (param_shapes, opt_shapes, batch), (pspecs, ospecs, bspecs)),
                    [Phase(grads_fn, (param_shapes, batch), (pspecs, bspecs), grad=True),
                     Phase(update_fn, (param_shapes, param_shapes, opt_shapes, loss),
                           (pspecs, pspecs, ospecs, P()))],
                    sizes, ctx_kw)
    if spec.kind == "prefill":
        def fn(ctx, params, b):
            return model(ctx).forward(params, b)

        step = Phase(fn, (param_shapes, batch), (pspecs, bspecs))
        return Cell(step, [step], sizes, ctx_kw)
    # decode
    plan = None
    if gather_weights:
        plan = _weight_gather_plan(param_shapes, pspecs, sizes.get("data", 1))
        pspecs = _apply_gather_specs(pspecs, param_shapes, plan)
    caches = Model(cfg, impl="reference", device="cpu").cache_specs(
        spec.global_batch, spec.seq_len)
    cspecs = cache_specs(caches, dp_entry, cp="data" if use_cp else None)

    def fn(ctx, params, tok, cc, pos):
        return model(ctx, weight_gather=plan).decode_step(params, tok, cc, pos)

    step = Phase(fn, (param_shapes, batch["token"], caches, batch["position"]),
                 (pspecs, P(dp_entry), cspecs, P()))
    return Cell(step, [step], sizes, ctx_kw)


def model_flops_per_device(cfg, shape: str, mesh_devices: int) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D for
    inference forward, divided evenly across chips."""
    spec = SHAPES[shape]
    n_active = cfg.active_param_count()
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        total = 6.0 * n_active * tokens
    elif spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * spec.global_batch
    return total / mesh_devices


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def cell_ir_stats(cell: Cell) -> dict:
    """:func:`analysis.collect_ir_stats` of a cell's per-rank program, its
    phases' counts summed."""
    return analysis.sum_ir_stats([
        analysis.collect_ir_stats(ph.fn, ph.avals, cell.sizes, ph.in_specs, grad=ph.grad,
                                  ctx_kw=cell.ctx_kw)
        for ph in cell.phases])


def memory_estimate(fn, avals: tuple, *, grad: bool) -> dict:
    """Bytes of one device running ``fn(*args)`` on arguments of the shapes
    ``avals``: the arguments' and
    outputs', and the peak, the most that ``MemTracker`` sees live over one
    eager run under ``FakeTensorMode``, the arguments included (each
    storage counted once, also where it is written in place).  A loop whose
    iterations leave nothing behind but carried values of fixed shape runs
    three iterations, after which its peak repeats: the microbatches (the
    running gradient sum is replaced, not grown; three give the peak all
    give, two give less, ``tests/test_torch_dryrun.py``) and, when ``fn``
    does not differentiate, the layers and attention chunks.
    (With gradients, each layer and chunk keeps what its backward reads.)
    Every other loop runs whole.  ``peak_bytes`` is None, with the reason,
    when the tracker cannot run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.scope import counting

    leaves, treedef = tree_flatten(avals)
    arg_bytes = sum(math.prod(a.shape) * torch.empty((), dtype=a.dtype).element_size()
                    for a in leaves)
    out = {"argument_bytes": arg_bytes, "output_bytes": None, "temp_bytes": None,
           "peak_bytes": None}
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
    except ImportError as e:
        out["peak_note"] = f"no MemTracker in torch {torch.__version__}: {e}"
        return out
    loops = ("micro",) if grad else ("micro", "layer", "chunk")
    with FakeTensorMode(), counting(loops, keep=3):
        args = tree_unflatten(treedef, [torch.empty(tuple(a.shape), dtype=a.dtype)
                                        for a in leaves])
        tracker = MemTracker()
        # known from the start: an op that writes an argument in place
        # returns a view of it, which the tracker would count again
        tracker.track_external(*tree_leaves(args))
        try:
            with tracker:
                result = fn(*args)
        except Exception as e:  # noqa: BLE001 - recorded, not made up
            out["peak_note"] = f"MemTracker failed: {type(e).__name__}: {e}"
            return out
        snap = tracker.get_tracker_snapshot("peak")
    out["output_bytes"] = _nbytes(tree_leaves(result))
    out["peak_bytes"] = sum(d.get("Total", 0) for d in snap.values())
    out["temp_bytes"] = out["peak_bytes"] - arg_bytes
    return out


def cell_memory(cell: Cell) -> dict:
    """:func:`memory_estimate` of one device of the cell: its per-rank
    arguments, under the fake process group over the cell's mesh."""
    from repro_torch.core.trace import fake_process_group, local_shape
    from repro_torch.parallel.ctx import ParallelCtx

    leaves, treedef = tree_flatten(cell.step.avals)
    specs = tree_leaves(tuple(cell.step.in_specs), is_leaf=is_spec)
    local = tree_unflatten(treedef, [ShapeDtype(local_shape(a.shape, s, cell.sizes), a.dtype)
                                     for a, s in zip(leaves, specs)])
    with fake_process_group(math.prod(cell.sizes.values()), cell.sizes) as dmesh:
        def run(*args):  # rank 0's context, its ranks made in the run's fake mode
            ranks = {a: torch.zeros((), dtype=torch.int64) for a in cell.sizes}
            return cell.step.fn(ParallelCtx.from_mesh(dmesh, ranks=ranks, **cell.ctx_kw),
                                *args)
        return memory_estimate(run, local, grad=any(ph.grad for ph in cell.phases))


def run_cell(arch: str, shape: str, *, multi_pod=False, zero1=False, sp=False,
             micro=0, compress="none", gather_weights=False, pure_dp=False,
             out_dir: Path = ARTIFACT_DIR, tag: str = "") -> dict:
    """Build, trace and account one cell, and write its artifact."""
    cfg = get_config(arch)
    reason = skip_reason(cfg, shape)
    mesh = production_mesh_sizes(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell_id = f"{arch}--{shape}--{mesh_name}" + (f"--{tag}" if tag else "")
    result: dict = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "tag": tag,
        "zero1": zero1, "sp": sp, "micro": micro, "compress": compress,
        "gather_weights": gather_weights, "pure_dp": pure_dp,
    }
    if reason:
        result["status"] = "skipped"
        result["skip_reason"] = reason
        _write(out_dir, cell_id, result)
        return result

    t0 = time.time()
    try:
        cell = build_cell(arch, shape, mesh, zero1=zero1, sp=sp, micro=micro,
                          compress=compress, gather_weights=gather_weights,
                          pure_dp=pure_dp)
        ir = cell_ir_stats(cell)
        t_trace = time.time() - t0
        mem = cell_memory(cell)
        mf = model_flops_per_device(cfg, shape, math.prod(mesh.values()))
        roof = analysis.roofline_terms(ir, model_flops_per_device=mf)
        result.update(
            status="ok",
            trace_s=round(t_trace, 2),
            memory_s=round(time.time() - t0 - t_trace, 2),
            memory=mem,
            ir={k: ir[k] for k in ("ir_dot_flops", "ir_ew_flops", "ir_hbm_bytes",
                                   "ir_kernel_saved_bytes", "ir_nodes")},
            collectives=ir["collectives"][:64],
            collective_wire_bytes=ir["collective_wire_bytes"],
            roofline=roof,
        )
    except Exception as e:  # record failures as artifacts, they are bugs to fix
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    result["wall_s"] = round(time.time() - t0, 2)
    _write(out_dir, cell_id, result)
    return result


def _write(out_dir: Path, cell_id: str, result: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{cell_id}.json", "w") as f:
        json.dump(result, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS + EXTRA_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--micro", type=int, default=0)
    ap.add_argument("--compress", default="none", choices=["none", "bf16", "int8"])
    ap.add_argument("--pure-dp", action="store_true",
                    help="re-shard as pure data parallelism over the whole mesh "
                         "(params replicated; pair with --zero1)")
    ap.add_argument("--gather-weights", action="store_true",
                    help="2D-shard serving weights over (model x data); "
                         "re-gather per block inside the layer loop")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--all", action="store_true", help="run every cell in subprocesses")
    args = ap.parse_args(argv)

    if args.all:
        import subprocess

        failures = []
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mp in (False, True):
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape, "--out", args.out]
                    if mp:
                        cmd.append("--multi-pod")
                    if subprocess.run(cmd).returncode != 0:
                        failures.append((arch, shape, mp))
        print("failures:", failures)
        sys.exit(1 if failures else 0)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --all)")

    res = run_cell(args.arch, args.shape, multi_pod=args.multi_pod, zero1=args.zero1,
                   sp=args.sp, micro=args.micro, compress=args.compress,
                   gather_weights=args.gather_weights, pure_dp=args.pure_dp,
                   out_dir=Path(args.out), tag=args.tag)
    status = res["status"]
    print(f"[{status}] {args.arch} {args.shape} mesh={res['mesh']} "
          f"wall={res.get('wall_s')}s")
    if status == "ok":
        print("  memory:", res["memory"])
        print("  roofline:", {k: (f'{v:.4g}' if isinstance(v, float) else v)
                              for k, v in res["roofline"].items()})
    elif status == "skipped":
        print("  skip:", res["skip_reason"])
    else:
        print(res["error"])
        print(res["traceback"])
        sys.exit(1)


if __name__ == "__main__":
    main()
