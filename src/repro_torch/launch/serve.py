"""Serving launcher: random-weight model + batched prefill/decode, with the
verification gate.

The flags are those of ``python -m repro.launch.serve`` plus ``--device``
(default ``cuda``; the run raises when no GPU is present unless
``--device cpu`` is given).  ``--verify-tp N`` runs the decode-plan
pre-flight (``repro_torch.verify``, ``Plan.decode(tp=N)``) on the host: the
decode step the engine runs, sharded N ways, is proven equivalent to the
single-device step before any weight is drawn; an invalid or unverified
plan exits 2.  As in the JAX launcher, ``--smoke`` is on by default and
cannot be turned off, so the CLI always runs the SMOKE config.

Usage:
  python -m repro_torch.launch.serve --arch qwen3_4b --requests 4 --max-new 8
  python -m repro_torch.launch.serve --arch qwen3_4b --verify-tp 2
  python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.models import Model
from repro_torch.serve import Engine, ServeConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3_4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, cuda:N or cpu)")
    ap.add_argument("--verify-tp", type=int, default=0,
                    help="pre-flight: verify the decode-step TP plan at this "
                         "degree before serving (0 = skip)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.encoder_only:
        print(f"{args.arch} is encoder-only: no decode serving")
        return 1

    if args.verify_tp > 1:
        from repro_torch.verify import Plan, Session

        plan = Plan.decode(tp=args.verify_tp, smoke=args.smoke,
                           layers=min(cfg.n_layers, 4), max_len=args.max_len)
        print(f"[verify] checking {args.arch} plan {plan.describe()} ...")
        try:
            with Session() as session:
                rep = session.verify(args.arch, plan)
        except ValueError as e:
            print(f"[verify] ABORTING: plan {plan.describe()} invalid for "
                  f"{args.arch}: {e}")
            return 2
        print(f"[verify] {rep.summary().splitlines()[0]}")
        if not rep.verified:
            print(rep.summary())
            print("[verify] ABORTING: serving parallelization not "
                  "semantically equivalent")
            return 2
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    eng = Engine(model, params, ServeConfig(max_len=args.max_len,
                                            batch_slots=args.slots))
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, size=rng.integers(3, 9)).tolist()
        rid = eng.submit(prompt, max_new=args.max_new)
        print(f"[submit] req {rid} prompt={prompt}")
    results = eng.run()
    dt = time.time() - t0
    total = sum(len(v) for v in results.values())
    for rid in sorted(results):
        print(f"[done] req {rid} -> {results[rid]}")
    print(f"[stats] {total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s incl. prefill) "
          f"on {model.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
