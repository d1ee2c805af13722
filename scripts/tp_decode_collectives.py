#!/usr/bin/env python3
"""Where the TP serving step's time goes on gloo ranks that share one card.

llama3_8b at full width with ``--layers`` layers, batch 2, as chip_smoke.py's
tp_decode phase runs it, on 1, 2 and 4 gloo ranks (``--worlds``) sharing
the card.  Each rank first times ``--steps`` decode steps as they run
(each step ended by ``torch.cuda.synchronize()``), then the same number
again with every all_reduce of the step timed alone: the card synchronized
before it, the collective, the card synchronized after it.  It prints one
JSON line per world size: per rank, the plain step's median ms, the
all_reduces a step, their mean and largest ms, and the instrumented step's
median ms.

    python3 scripts/tp_decode_collectives.py [--layers 2] [--steps 20] [--worlds 1 2 4]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402


def rank_steps(rank: int, world: int, cfg, seed: int, steps: int) -> dict:
    from repro_torch.parallel.ctx import ParallelCtx

    model, params = spmd._rank_model(rank, world, cfg, seed, "reference", "cuda")
    caches = model.init_cache(2, 64)
    tok = torch.ones(2, dtype=torch.int64, device="cuda")

    def run(n: int, t0: int) -> list:
        times = []
        for t in range(t0, t0 + n):
            pos = torch.full((), t, dtype=torch.int64, device="cuda")
            torch.cuda.synchronize()
            start = time.perf_counter()
            model.decode_step(params, tok, caches, pos)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        return times

    reduce_ms = []
    plain = ParallelCtx._all_reduce

    def timed(self, x, op):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = plain(self, x, op)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - start) * 1e3)
        return out

    with torch.inference_mode():
        run(2, 0)  # warm-up
        step = run(steps, 2)
        ParallelCtx._all_reduce = timed
        try:
            inst = run(steps, 2 + steps)
        finally:
            ParallelCtx._all_reduce = plain
    return {"step_ms_median": statistics.median(step),
            "all_reduces_per_step": len(reduce_ms) / steps,
            "all_reduce_ms_mean": statistics.fmean(reduce_ms),
            "all_reduce_ms_max": max(reduce_ms),
            "instrumented_step_ms_median": statistics.median(inst)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_decode_collectives.py needs a CUDA device", file=sys.stderr)
        return 1
    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=args.layers)
    for world in args.worlds:
        t0 = time.perf_counter()
        ranks = spmd.run(rank_steps, world, (cfg, args.seed, args.steps), timeout=600)
        print(json.dumps({"world": world, "layers": args.layers, "steps": args.steps,
                          "seconds": time.perf_counter() - t0, "ranks": ranks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
