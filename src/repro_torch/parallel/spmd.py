"""Run one per-rank program on ``world`` ranks: the port's counterpart of
executing a ``shard_map`` over a mesh.

:func:`run` spawns ``world`` processes with ``torch.multiprocessing``, joins
them in one process group (``tcp://127.0.0.1`` on a free port), calls
``fn(rank, world, *args)`` in each and returns each rank's result, in rank
order.  ``fn`` must be importable (a module-level function) and its result
picklable.

The backend is gloo on both devices.  On one H100 the ranks share the card,
and NCCL refuses two ranks on one device; gloo stages CUDA tensors through
the host, which is fine for a check of numbers and changes nothing the
program computes.  On the CPU gloo runs over CPU tensors.

:func:`tp_forward` is the per-rank program of Megatron TP for a model
config: each rank draws the single-device parameter set from one seed,
keeps its shard (``param_specs``), and runs the forward pass with the
collectives of ``ParallelCtx.tensor_parallel`` (sequence-parallel with
``sp``; a MoE config's experts are split over the ranks, each running the
capacity dispatch for its own).  :func:`tp_decode` is its serving
counterpart: the decode step the verifier's ``tp-decode`` scenario proves,
fed one position at a time against this rank's shard of the caches
(``cache_specs``).
:func:`dp_forward` is the per-rank program of the verifier's ``dp-forward``
scenario: every rank holds the whole single-device parameter set and runs
the forward pass on its rows of the batch.
:func:`tpdp_forward` runs both axes at once over a (data, model) mesh, the
program of the ``tpdp-forward`` scenario, and :func:`pipeline_tp_forward`
streams microbatches through ``pipeline_forward`` over a ("pod", "model")
mesh, each stage the program of the ``stage`` scenario.
:func:`train_step` runs steps of the trainer's ``make_step_fn`` over a
(data, model) mesh, the port's counterpart of the JAX package's
``shard_map`` of the train step.
:func:`dp_grad` is the per-rank program of the verifier's ``dp-grad``
scenario (the gradients of the rank's forward sum, psummed over the data
axis), which a rank runs on its rows.
:func:`cp_decode` runs the decode step with the KV cache cut along the
sequence over a context-parallel axis (and over heads on the model axis).
"""
from __future__ import annotations

import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable

import torch

from repro_torch.tree import tree_map


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(fn, rank: int, world: int, port: int, args: tuple, results) -> None:
    import torch.distributed as dist

    # gloo binds to the interface the host name resolves to, and hangs where
    # that is not reachable; the ranks all run on this host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # the ranks share the host's cores: more threads a rank only contend
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        try:
            # plain pickle bytes: a tensor sent through a torch queue is a
            # shared-memory handle, which dies with the rank's process
            results.put((rank, True, pickle.dumps(fn(rank, world, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:  # report to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run(fn: Callable, world: int, args: tuple = (), timeout: float = 600.0) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its own
    spawned process of one gloo process group.  Raises if a rank fails or
    the ranks do not finish within ``timeout`` seconds; no process is left
    running either way."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(fn, r, world, port, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    errors = []
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(errors) < world:
            try:
                rank, ok, value = results.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} did not "
                                   f"finish within {timeout} s") from None
            if ok:
                out[rank] = pickle.loads(value)
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("a rank failed: " + "\n".join(errors))
    return [out[r] for r in range(world)]


def _model_shard(cfg, seed: int, impl: str, dev: torch.device, coord: int, tp: int):
    """The single-device parameters drawn from ``seed``, cut to the shard at
    coordinate ``coord`` of a ``tp``-rank model axis (``param_specs``)."""
    from repro_torch.models import Model
    from repro_torch.parallel.sharding import param_specs, shard_params

    full = Model(cfg, impl=impl, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    return shard_params(full, param_specs(full), coord, tp)


def _rank_model(rank: int, world: int, cfg, seed: int, impl: str, device: str,
                sp: bool = False):
    """This rank's model and its shard of the single-device parameters drawn
    from ``seed``."""
    from repro_torch.models import Model
    from repro_torch.parallel.ctx import ParallelCtx

    dev = torch.device(device)
    params = _model_shard(cfg, seed, impl, dev, rank, world)
    ctx = ParallelCtx.tensor_parallel(
        world, rank=torch.tensor(rank, dtype=torch.int64, device=dev), sp=sp)
    return Model(cfg, ctx, impl=impl, device=dev), params


def _timed(dev: torch.device, fn):
    """``fn()`` and its host time in ms, the card synchronized around it."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def tp_forward(rank: int, world: int, cfg, seed: int, inputs, impl: str = "kernel",
               device: str = "cuda", sp: bool = False) -> dict:
    """One rank of the TP forward pass of ``cfg`` (on the card unless
    ``device`` says otherwise; sequence-parallel with ``sp``) over
    ``inputs``: tokens (B, S), or a batch dict (a frontend's frames, or
    patches beside tokens), which every rank holds whole.  Returns this
    rank's vocab shard of the logits (on the CPU), the forward time in ms,
    ``dropped``, the (token, slot) pairs of this rank's experts that
    capacity dropped, summed over the MoE layers (0 without experts), and
    ``topk``, each MoE layer's top-k expert ids (T, K) (on the CPU)."""
    from repro_torch.models.mlp import record_routing

    model, params = _rank_model(rank, world, cfg, seed, impl, device, sp)
    dev = model.device
    batch = tree_map(lambda t: t.to(dev),
                     inputs if isinstance(inputs, dict) else {"tokens": inputs})
    with torch.inference_mode(), record_routing() as routing:
        logits, ms = _timed(dev, lambda: model.forward(params, batch))
    return {"logits": logits.cpu(), "ms": ms,
            "dropped": sum(int(r["dropped"]) for r in routing),
            "topk": [r["idx"].cpu() for r in routing]}


def tp_decode(rank: int, world: int, cfg, seed: int, tokens: torch.Tensor,
              max_len: int, device: str = "cuda") -> dict:
    """One rank of the TP serving step of ``cfg``: ``tokens`` (B, T) are fed
    through ``decode_step`` one position at a time, position ``t`` taking
    ``tokens[:, t]``, against this rank's shard of zeroed caches of
    ``max_len`` positions.  Returns each step's vocab shard of the logits
    (T, B, V_loc), the final cache shards (on the CPU) and the mean time of
    one step in ms."""
    model, params = _rank_model(rank, world, cfg, seed, "reference", device)
    dev = model.device
    caches = model.init_cache(tokens.shape[0], max_len)
    tokens = tokens.to(dev)
    logits = []
    with torch.inference_mode():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(tokens.shape[1]):
            pos = torch.full((), t, dtype=torch.int64, device=dev)
            out, caches = model.decode_step(params, tokens[:, t], caches, pos)
            logits.append(out)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / tokens.shape[1]
    return {"logits": torch.stack(logits).cpu(),
            "caches": tree_map(lambda c: c.cpu(), caches), "ms": ms}


def dp_forward(rank: int, world: int, cfg, seed: int, tokens: torch.Tensor,
               impl: str = "kernel", device: str = "cuda") -> dict:
    """One rank of the data-parallel forward pass of ``cfg`` (on the card
    unless ``device`` says otherwise): the parameters drawn from ``seed``
    whole, the forward pass on this rank's rows of ``tokens`` (B, S) (a
    ``world``-th of them, in rank order).  Returns this rank's logits (on
    the CPU) and the forward time in ms."""
    from repro_torch.models import Model
    from repro_torch.parallel.ctx import ParallelCtx

    if tokens.shape[0] % world:
        raise ValueError(f"batch {tokens.shape[0]} is not divisible by dp={world}")
    dev = torch.device(device)
    ctx = ParallelCtx(dp_axis=("data",), dp_size=world)
    model = Model(cfg, ctx, impl=impl, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    rows = tokens.shape[0] // world
    batch = {"tokens": tokens[rank * rows:(rank + 1) * rows].to(dev)}
    with torch.inference_mode():
        logits, ms = _timed(dev, lambda: model.forward(params, batch))
    return {"logits": logits.cpu(), "ms": ms}


def tpdp_forward(rank: int, world: int, cfg, seed: int, tokens: torch.Tensor, tp: int,
                 impl: str = "kernel", device: str = "cuda") -> dict:
    """One rank of the tp x dp forward pass of ``cfg`` (on the card unless
    ``device`` says otherwise), the program the verifier's ``tpdp-forward``
    scenario proves: the ranks form a (data, model) = (world / tp, tp) mesh
    (``make_debug_mesh``); each draws the single-device parameters from
    ``seed``, keeps the shard of its model coordinate, and runs the forward
    pass on the rows of ``tokens`` (B, S) at its data coordinate, with the
    model-axis collectives on the model axis' group.  Returns the rank's
    coordinates, its (rows, vocab shard) block of the logits (on the CPU)
    and the forward time in ms."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model
    from repro_torch.parallel.ctx import ParallelCtx

    dp = world // tp
    if world % tp or tokens.shape[0] % dp:
        raise ValueError(f"{world} ranks at tp={tp} do not split batch {tokens.shape[0]}")
    dev = torch.device(device)
    mesh = make_debug_mesh(tp, dp, device_type=dev.type)
    ctx = ParallelCtx.from_mesh(mesh)
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    params = _model_shard(cfg, seed, impl, dev, m, tp)
    model = Model(cfg, ctx, impl=impl, device=dev)
    rows = tokens.shape[0] // dp
    batch = {"tokens": tokens[d * rows:(d + 1) * rows].to(dev)}
    with torch.inference_mode():
        logits, ms = _timed(dev, lambda: model.forward(params, batch))
    return {"data": d, "model": m, "logits": logits.cpu(), "ms": ms}


def pipeline_tp_forward(rank: int, world: int, cfg, seed: int, tokens: torch.Tensor,
                        stages: int, n_micro: int, impl: str = "kernel",
                        device: str = "cuda") -> dict:
    """One rank of the pipeline x TP forward pass of ``cfg`` (on the card
    unless ``device`` says otherwise) over a ("pod", "model") = (stages,
    world / stages) mesh.  Each rank draws the single-device parameters
    from ``seed``, keeps the shard of its model coordinate and, of the
    layer stack, only its stage's layers.  Every rank embeds each of the
    ``n_micro`` microbatches of ``tokens`` (B, S) (``vp_embed``), runs them
    through ``pipeline_forward``, whose stage function is the stage's TP
    layer slice (the program the ``stage`` scenario proves, without the
    frontend and head), then the final norm and the head.  Returns the
    rank's coordinates, its vocab shard of the logits (B, S, V_loc) (on
    the CPU), the time of the whole pass in ms and the route the ring's
    activations take (``parallel/pipeline.ring_shift``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.modules import rmsnorm
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.parallel.pipeline import pipeline_forward, stage_program

    tp, period = world // stages, cfg.block_period
    per_stage = cfg.n_layers // stages
    if world % stages or cfg.n_layers % stages or per_stage % period \
            or tokens.shape[0] % n_micro:
        raise ValueError(f"{cfg.n_layers} layers and batch {tokens.shape[0]} do not split "
                         f"into {stages} stages of whole block periods and {n_micro} "
                         f"microbatches on {world} ranks")
    dev = torch.device(device)
    mesh = make_mesh((stages, tp), ("pod", "model"), device_type=dev.type)
    ctx = ParallelCtx.from_mesh(mesh, dp=None)
    s, m = mesh.get_local_rank("pod"), mesh.get_local_rank("model")
    params = _model_shard(cfg, seed, impl, dev, m, tp)
    lo, hi = s * per_stage, (s + 1) * per_stage
    # this stage's layers only: each block position's slice, copied, so the
    # other stages' layers are freed
    params["blocks"] = tuple(tree_map(lambda a: a[lo // period:hi // period].clone(), blk)
                             for blk in params["blocks"])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    model = Model(cfg, ctx, impl=impl, device=dev)
    stage_fn = stage_program(model, lo, hi, first_block=lo // period)
    micro = tokens.to(dev).reshape(n_micro, tokens.shape[0] // n_micro, *tokens.shape[1:])

    def run():
        x = torch.stack([model._inputs_to_hidden(params, {"tokens": t}) for t in micro])
        y = pipeline_forward(stage_fn, params, x, n_stages=stages, ctx=ctx)
        y = rmsnorm(params["ln_f"], y.flatten(0, 1), cfg.norm_eps)
        return model._head(params, y)

    with torch.inference_mode():
        logits, ms = _timed(dev, run)
    ring = ("gloo all_to_all of CPU tensors" if dev.type == "cpu" else
            f"{dev.type} -> host copy -> gloo all_to_all of CPU tensors -> {dev.type}")
    return {"pod": s, "model": m, "logits": logits.cpu(), "ms": ms, "ring": ring}


def train_step(rank: int, world: int, cfg, init, batches: list, tp: int, tcfg,
               device: str = "cuda", sp: bool = False, grads: bool = False) -> dict:
    """One rank of the trainer's step over a (data, model) = (world / tp, tp)
    mesh (``make_debug_mesh``), on ``impl="reference"`` (the kernels have
    no backward), on the card unless ``device`` says otherwise.  ``init``
    is a seed from which every rank draws the single-device parameters, or
    that parameter tree itself (CPU tensors); each rank keeps the shard of
    its model coordinate (``param_specs``) and starts from ``adamw_init``,
    or with ``tcfg.zero1`` from ``zero1_init``'s moments, a data-axis
    slice of each leaf's ``_zero_flags_from_specs`` dim.  Each of
    ``batches`` (global batches, dicts of CPU tensors) is one step, the
    rank taking the rows at its data coordinate.  Returns the rank's
    coordinates, each step's loss, metrics and ms, the updated parameter
    shards and optimizer moments and, with ``grads``, the first batch's
    local gradients (before any data-axis reduction), all on the CPU."""
    from repro_torch.launch.dryrun import _zero_flags_from_specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.parallel.sharding import param_specs, shard_params
    from repro_torch.train.optimizer import adamw_init, zero1_init
    from repro_torch.train.trainer import local_grads, make_step_fn

    dp = world // tp
    dev = torch.device(device)
    mesh = make_debug_mesh(tp, dp, device_type=dev.type)
    ctx = ParallelCtx.from_mesh(mesh, sp=sp)
    d, m = int(ctx.dp_index()), mesh.get_local_rank("model")
    model = Model(cfg, ctx, impl="reference", device=dev)
    if isinstance(init, int):
        full = Model(cfg, impl="reference", device=dev).init(
            torch.Generator(device=dev).manual_seed(init))
    else:
        # a copy: the step updates in place, and a replicated leaf's shard
        # is the leaf itself
        full = tree_map(lambda t: t.to(dev, copy=True), init)
    pspecs = param_specs(full)
    flags = _zero_flags_from_specs(full, dp, pspecs) if tcfg.zero1 else None
    params = shard_params(full, pspecs, m, tp)
    del full
    opt = adamw_init(params) if flags is None else zero1_init(params, dp, flags)
    step_fn = make_step_fn(model, tcfg, shard_flags=flags)

    def rows(batch):
        n = next(iter(batch.values())).shape[0] // dp
        return tree_map(lambda x: x[d * n:(d + 1) * n].to(dev), batch)

    out = {"data": d, "model": m, "losses": [], "metrics": [], "ms": []}
    if grads:
        out["grads"] = tree_map(lambda g: g.cpu(),
                                local_grads(model, tcfg, params, rows(batches[0]))[1])
    for batch in batches:
        local = rows(batch)
        (params, opt, metrics), ms = _timed(dev, lambda: step_fn(params, opt, local))
        out["losses"].append(float(metrics["loss"]))
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["ms"].append(ms)
    out["params"] = tree_map(lambda t: t.cpu(), params)
    out["opt"] = {k: tree_map(lambda t: t.cpu(), opt[k]) for k in ("m", "v")}
    return out


def sum_grads(model, params, batch) -> dict:
    """The gradients of ``model.forward(params, batch).float().sum()`` with
    respect to every leaf of ``params`` (``jax.grad`` of the forward sum;
    zeros for a leaf the forward does not read), through the trainer's
    autograd path, on the model's path (``impl="reference"``: the kernels
    have no backward)."""
    from repro_torch.train.trainer import value_and_grad

    return value_and_grad(lambda p: model.forward(p, batch).float().sum(), params)[1]


def dp_grad(model, params, batch) -> dict:
    """One rank of the data-parallel gradient sync, the program the
    verifier's ``dp-grad`` scenario proves: the gradients of this rank's
    forward sum over its rows, each psummed over the data axis.  The loss
    is a sum, so the psum gives the full batch's gradients with no
    ``1 / dp``."""
    grads = sum_grads(model, params, batch)
    return tree_map(model.ctx.psum_dp, grads)


def cp_decode(rank: int, world: int, cfg, init, tokens: torch.Tensor, start: int,
              caches, tp: int, device: str = "cuda") -> dict:
    """One rank of the context-parallel decode step of ``cfg`` (on the card
    unless ``device`` says otherwise) over a (data, model) = (world / tp,
    tp) mesh, the data axis the context-parallel one
    (``ParallelCtx.from_mesh(mesh, dp=None, cp="data")``).  ``init`` is a
    seed from which the single-device parameters are drawn, or that tree
    itself (CPU tensors); the rank keeps the shard of its model coordinate.
    ``caches`` are the single-device caches (CPU tensors, filled up to
    ``start``); the rank keeps its (head, sequence) shard of each
    (``cache_specs(..., cp="data")``).  ``tokens`` (B, T) are fed one step
    at a time, step ``t`` at position ``start + t``.  Returns the rank's
    coordinates, each step's vocab shard of the logits (T, B, V_loc) (on
    the CPU) and the mean time of one step in ms."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.parallel.sharding import cache_specs, param_specs, shard_params

    cp = world // tp
    dev = torch.device(device)
    mesh = make_debug_mesh(tp, cp, device_type=dev.type)
    ctx = ParallelCtx.from_mesh(mesh, dp=None, cp="data")
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    if isinstance(init, int):
        params = _model_shard(cfg, init, "reference", dev, m, tp)
    else:
        params = shard_params(init, param_specs(init), m, tp)
        params = tree_map(lambda t: t.to(dev), params)
    local = shard_params(caches, cache_specs(caches, cp="data"), {"model": m, "data": d},
                         {"model": tp, "data": cp})
    # a copy: the step writes its caches in place, and a leaf no axis cuts
    # is the caller's tensor itself (shared with the other ranks on the CPU)
    local = tree_map(lambda t: t.to(dev, copy=True), local)
    model = Model(cfg, ctx, impl="reference", device=dev)
    tokens = tokens.to(dev)
    logits = []
    with torch.inference_mode():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(tokens.shape[1]):
            pos = torch.full((), start + t, dtype=torch.int64, device=dev)
            out, local = model.decode_step(params, tokens[:, t], local, pos)
            logits.append(out)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / tokens.shape[1]
    return {"data": d, "model": m, "logits": torch.stack(logits).cpu(), "ms": ms}
