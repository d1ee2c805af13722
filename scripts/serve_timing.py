#!/usr/bin/env python3
"""Serving throughput of the port's engine, for comparing two trees on one card.

Runs the workload of chip_smoke.py's serve phase (four requests, prompts of
3-8 tokens from the same generator, 2 slots, 8 new tokens each, max_len 64,
random weights from ``--seed``) through ``repro_torch.serve.Engine``: first
the run chip_smoke.py times (cold: the first decode steps of the process),
then ``--repeat`` warm runs.  Then it times ``--steps`` decode steps of
batch 2 alone, each ended by ``torch.cuda.synchronize()``.  It prints one
JSON line per arch.

``--src DIR`` imports ``repro_torch`` from ``DIR`` (a ``src`` directory of
another checkout, such as ``git archive`` of a parent commit), so two trees
can be timed on one host in one session:

    python3 scripts/serve_timing.py --src /path/to/parent/src --arch qwen3_4b mamba2_130m

It uses only what the engine's API had before the decode step took a
tensor position (the step is called with an int position here).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch


def serve_once(Engine, ServeConfig, model, params, cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(3, 9)).tolist()
               for _ in range(4)]
    eng = Engine(model, params, ServeConfig(max_len=64, batch_slots=2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new=8) for p in prompts]
    results = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(results[i]) for i in ids)
    return {"seconds": dt, "tokens": total, "tokens_per_s": total / dt}


def step_ms(model, params, n: int) -> dict:
    caches = model.init_cache(2, 64)
    tok = torch.ones(2, dtype=torch.int64, device="cuda")
    times = []
    for t in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, caches = model.decode_step(params, tok, caches, t)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    warm = times[2:]
    return {"step_ms_median": statistics.median(warm), "step_ms_min": min(warm),
            "step_ms_first": times[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--arch", nargs="+", default=["qwen3_4b", "mamba2_130m"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_timing.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import Engine, ServeConfig

    for arch in args.arch:
        cfg = get_config(arch)
        model = Model(cfg, device="cuda")
        with torch.inference_mode():
            params = model.init(torch.Generator(device="cuda").manual_seed(args.seed))
            cold = serve_once(Engine, ServeConfig, model, params, cfg, args.seed)
            warm = [serve_once(Engine, ServeConfig, model, params, cfg, args.seed)
                    for _ in range(args.repeat)]
            steps = step_ms(model, params, args.steps)
        print(json.dumps({"label": args.label, "src": args.src, "arch": arch,
                          "cold_tokens_per_s": cold["tokens_per_s"],
                          "warm_tokens_per_s": [w["tokens_per_s"] for w in warm],
                          "warm_tokens_per_s_median": statistics.median(
                              w["tokens_per_s"] for w in warm), **steps}), flush=True)
        del model, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
