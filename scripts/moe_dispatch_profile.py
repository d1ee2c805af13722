#!/usr/bin/env python3
"""Where the capacity dispatch's time goes on the card: one MoE layer of
granite_moe_3b (or mixtral_8x7b) at full width, ``mlp.moe_fwd`` on
(2, 1024) tokens of N(0, 1) inputs, under ``torch.profiler``.  Prints the
host-clock time of one call (CUDA events around ``--iters`` eager calls),
the device time summed by kernel (``key_averages``, the ten largest), the
device's busy share of the profiled window, and the card's name and power
limit.

    python3 scripts/moe_dispatch_profile.py [--arch granite_moe_3b] [--iters 20]

Needs one GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=("granite_moe_3b", "mixtral_8x7b"),
                    default="granite_moe_3b")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_dispatch_profile: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = get_config(args.arch)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    p = mlp.moe_init(gen, cfg)
    x = torch.randn((2, 1024, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = ParallelCtx.single()
    with torch.inference_mode():
        for _ in range(3):
            mlp.moe_fwd(cfg, ctx, p, x)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            mlp.moe_fwd(cfg, ctx, p, x)
        end.record()
        end.synchronize()
        call_ms = start.elapsed_time(end) / args.iters
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(args.iters):
                mlp.moe_fwd(cfg, ctx, p, x)
            t1.record()
            t1.synchronize()
    window_ms = t0.elapsed_time(t1)
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if dev_us and not e.key.startswith("aten::"):
            rows.append((dev_us / args.iters / 1e3, e.count // args.iters, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * args.iters
    print(json.dumps({"arch": cfg.name, "tokens": [2, 1024], "experts": cfg.experts,
                      "top_k": cfg.top_k, "capacity": mlp.moe_capacity(cfg, 2048),
                      "call_ms": call_ms, "profiled_window_ms": window_ms,
                      "device_busy_share": busy / window_ms if window_ms else None,
                      "kernels_ms_per_call": [{"ms": ms, "launches": n, "kernel": k[:120]}
                                              for ms, n, k in rows[:10]],
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
