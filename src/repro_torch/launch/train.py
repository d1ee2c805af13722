"""Training launcher with the Scalify verification gate.

Flow, as in ``python -m repro.launch.train``:
  1. VERIFY: for ``--tp > 1`` or ``--dp > 1``, the port's ``Session`` proves
     the launch's plan (TP forward, sequence-parallel with ``--sp``, and,
     for archs without experts, DP batch sharding) on the host before any
     weight is drawn; an unverified plan exits 2.
  2. TRAIN: ``--tp 1 --dp 1`` trains in this process on ``--device``;
     otherwise ``tp x dp`` gloo ranks (``parallel.spmd.run``) each run the
     train step of their (data, model) mesh coordinate, on the card (the
     ranks sharing it) or on the CPU, with checkpoints of the full logical
     leaves and resumable data.  Rank 0's log is printed when the ranks end.

The flags are the JAX launcher's plus ``--device`` (default ``cuda``; the
run raises when no GPU is present unless ``--device cpu`` is given).  One
launch is refused with exit 2 before any weight is drawn: ``--zero1`` with
``--dp > 1``, where the JAX launcher crashes (it builds full-size moments
under the param specs, and ``zero1_update`` meets scattered shards: "add
got incompatible shapes"; ``zero1_update`` itself is ported and tested).
``--sp`` runs on the card as on CPU ranks: its sequence gathers and
scatters of CUDA tensors go through a host copy (``ParallelCtx``).

Usage:
  python -m repro_torch.launch.train --arch qwen3_4b --smoke --steps 40 --tp 2 --dp 2
  python -m repro_torch.launch.train --arch qwen3_4b --smoke --tp 2 --dp 2 --sp
  python -m repro_torch.launch.train --arch qwen3_4b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models.model import Model, resolve_device
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import P, param_specs, shard_params, unshard_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import TrainConfig, make_step_fn
from repro_torch.tree import tree_map


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3_4b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--compress", default="none", choices=["none", "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--skip-verify", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, cuda:N or cpu)")
    return ap


def _train(rank: int, world: int, args, log) -> None:
    """The training loop of one rank of a ``world``-rank (data, model) mesh
    (``world == 1``: this process alone, a single-device context); ``log``
    takes rank 0's lines."""
    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    if world > 1:
        from repro_torch.launch.mesh import make_debug_mesh

        mesh = make_debug_mesh(tp=args.tp, dp=args.dp, device_type=dev.type)
        ctx = ParallelCtx.from_mesh(mesh, dp=("data",), sp=args.sp)
        d, m = int(ctx.dp_index()), mesh.get_local_rank("model")
    else:
        ctx, d, m = ParallelCtx.single(), 0, 0
    log = log if rank == 0 else (lambda line: None)
    # training runs impl="reference", as the JAX launcher trains on its
    # reference path: the kernels have no backward (kernels/ops.py)
    model = Model(cfg, ctx, impl="reference", device=dev)
    tcfg = TrainConfig(opt=AdamWConfig(lr=args.lr, warmup_steps=10,
                                       total_steps=max(args.steps, 100)),
                       microbatches=args.micro, remat=False, zero1=args.zero1,
                       grad_compress=args.compress)

    params = Model(cfg, impl="reference", device=dev).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    opt = adamw_init(params)
    start_step = 0
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and ckpt_dir:
        latest = ckpt.latest(ckpt_dir)
        if latest:
            state, meta = ckpt.restore(latest, (params, opt))
            params, opt = tree_map(lambda t: t.to(dev), state)
            start_step = meta["step"]
            log(f"[ckpt] resumed from {latest} at step {start_step}")

    pspecs = param_specs(params)
    specs = (pspecs, {"m": pspecs, "v": pspecs, "step": P()})
    params, opt = shard_params((params, opt), specs, m, args.tp)
    data = SyntheticLM(DataConfig(cfg.vocab, args.seq, args.batch, seed=args.seed))
    rows = args.batch // args.dp
    step_fn = make_step_fn(model, tcfg)

    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = tree_map(lambda x: x[d * rows:(d + 1) * rows].to(dev), data.batch_at(step))
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            log(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({(time.time()-t0)/(step-start_step+1):.2f}s/step)")
        if ckpt_dir and (step + 1) % args.ckpt_every == 0:
            full = unshard_params((params, opt), specs, ctx)
            if rank == 0:
                ckpt.save(ckpt_dir, step + 1, full)
            del full
            log(f"[ckpt] saved step {step + 1}")
    log(f"[done] {args.steps - start_step} steps in {time.time()-t0:.1f}s")


def _train_rank(rank: int, world: int, args) -> list:
    lines: list = []
    _train(rank, world, args, lines.append)
    return lines


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    if args.zero1 and args.dp > 1:
        print("[train] REFUSED: --zero1 with --dp > 1 crashes the JAX launcher "
              "(full-size adamw_init moments under the param specs meet "
              "zero1_update's scattered shards: 'add got incompatible shapes'); "
              "a fix changes both packages")
        return 2

    # ---- 1. verification gate (paper technique) -------------------------------
    if not args.skip_verify and (args.tp > 1 or args.dp > 1):
        from repro_torch.verify import Plan, PlanError, Session

        dp_gate = args.dp if args.dp > 1 and cfg.n_experts == 0 else 1
        try:
            plan = Plan(tp=args.tp, dp=dp_gate, sp=args.sp and args.tp > 1,
                        layers=min(cfg.n_layers, 4), seq=32, smoke=args.smoke)
        except PlanError:
            plan = None  # tp=1 and dp gate skipped: nothing to verify
        if plan is not None:
            print(f"[verify] checking {args.arch} plan {plan.describe()} "
                  f"graph equivalence ...")
            t0 = time.time()
            with Session() as session:
                rep = session.verify(args.arch, plan)
            print(f"[verify] {rep.summary().splitlines()[0]} "
                  f"({time.time()-t0:.2f}s)")
            if not rep.verified:
                print(rep.summary())
                print("[verify] ABORTING: parallelization not semantically "
                      "equivalent")
                return 2

    # ---- 2. training ----------------------------------------------------------------
    world = args.tp * args.dp
    if world == 1:
        _train(0, 1, args, print)
    else:
        from repro_torch.parallel import spmd

        for line in spmd.run(_train_rank, world, (args,), timeout=3600)[0]:
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
