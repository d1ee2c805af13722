#!/usr/bin/env python3
"""CPU emulation behind chip_smoke.py's tp_forward, tp_decode and dp_forward
logit bounds.

chip_smoke.py runs llama3_8b at full width with 2 layers as Megatron TP on
4 gloo ranks, in bf16, and holds the gathered logits to the single-device
model's.  TP changes only the order of the row-parallel sums: each rank's
output projections give bf16 partial sums that the all_reduce adds, where
one device rounds one full-width sum.  This script makes the same
comparison on the CPU (gloo ranks over CPU tensors, the reference attention
path, the same seeds' kind of weights and tokens) and prints relative RMS
and max abs error, in bf16 and, as a control, in f32.  With ``--decode`` it
compares the serving step instead: a batch of ``--batch`` rows fed
``--prompt`` + ``--steps`` tokens one position at a time through
``decode_step`` (``spmd.tp_decode`` on the ranks), every step's logits
against the single-device step's, and each rank's final cache shards
against the single-device caches' shards.  With ``--dp N`` it compares the
data-parallel forward (``spmd.dp_forward``, gemma_2b at full depth):
``--batch`` rows of ``--seq`` tokens split over N ranks, each
holding every parameter, through the kernels' plain versions as on the
card, each rank's logits against its rows of the single-device forward of
the whole batch.

    python3 scripts/tp_logit_bounds.py [--layers 2] [--seq 1024] [--tp 4] [--smoke]
    python3 scripts/tp_logit_bounds.py --decode [--prompt 32] [--steps 8] [--batch 2]
    python3 scripts/tp_logit_bounds.py --dp 2 [--seq 1024] [--batch 2]

Full width needs about 4 GB of host memory per rank plus 4 GB for the
single-device model (llama3_8b's embedding and head are 0.5 G parameters
each), twice that for the f32 control; ``--dp 2`` for gemma_2b about 5 GB a
rank and 5 GB for the single-device model.  Run it where the host has that
to spare.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.sharding import cache_specs, shard_params  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

DECODE_MAX_LEN = 64  # chip_smoke.py's tp_decode caches


def compare(cfg, tp: int, seed: int, tokens) -> dict:
    model = Model(cfg, impl="reference", device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        ref = model.forward(params, {"tokens": tokens}).float()
    del params
    t0 = time.perf_counter()
    ranks = spmd.run(spmd.tp_forward, tp, (cfg, seed, tokens, "reference", "cpu"),
                     timeout=3000)
    got = torch.cat([r["logits"] for r in ranks], dim=-1).float()
    diff = got - ref
    return {"dtype": cfg.dtype, "rel_rms_err": (diff.norm() / ref.norm()).item(),
            "max_abs_err": diff.abs().max().item(),
            "ref_rms": ref.pow(2).mean().sqrt().item(),
            "tp_seconds": time.perf_counter() - t0}


def compare_decode(cfg, tp: int, seed: int, tokens) -> dict:
    model = Model(cfg, impl="reference", device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    caches = model.init_cache(tokens.shape[0], DECODE_MAX_LEN)
    steps = []
    with torch.inference_mode():
        for t in range(tokens.shape[1]):
            logits, caches = model.decode_step(params, tokens[:, t], caches, t)
            steps.append(logits.float())
    del params
    ref = torch.stack(steps)
    t0 = time.perf_counter()
    ranks = spmd.run(spmd.tp_decode, tp, (cfg, seed, tokens, DECODE_MAX_LEN, "cpu"),
                     timeout=3000)
    got = torch.cat([r["logits"] for r in ranks], dim=-1).float()
    diff = got - ref
    specs = cache_specs(caches)
    cache_rel, cache_abs = 0.0, 0.0
    for rank, out in enumerate(ranks):
        want = tree_leaves(shard_params(caches, specs, rank, tp))
        for a, b in zip(tree_leaves(out["caches"]), want):
            d = a.float() - b.float()
            cache_rel = max(cache_rel, (d.norm() / b.float().norm()).item())
            cache_abs = max(cache_abs, d.abs().max().item())
    return {"dtype": cfg.dtype, "rel_rms_err": (diff.norm() / ref.norm()).item(),
            "max_abs_err": diff.abs().max().item(),
            "worst_step_rel_rms_err": max((d.norm() / r.norm()).item()
                                          for d, r in zip(diff, ref)),
            "cache_rel_rms_err": cache_rel, "cache_max_abs_err": cache_abs,
            "ref_rms": ref.pow(2).mean().sqrt().item(),
            "tp_ms_per_step": [r["ms"] for r in ranks],
            "tp_seconds": time.perf_counter() - t0}


def compare_dp(cfg, dp: int, seed: int, tokens) -> dict:
    model = Model(cfg, impl="kernel", device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        ref = model.forward(params, {"tokens": tokens}).float()
    del params
    t0 = time.perf_counter()
    ranks = spmd.run(spmd.dp_forward, dp, (cfg, seed, tokens, "kernel", "cpu"), timeout=3000)
    rows = tokens.shape[0] // dp
    per_rank = []
    for r, out in enumerate(ranks):
        want = ref[r * rows:(r + 1) * rows]
        diff = out["logits"].float() - want
        per_rank.append({"rel_rms_err": (diff.norm() / want.norm()).item(),
                         "max_abs_err": diff.abs().max().item()})
    return {"dtype": cfg.dtype, "per_rank": per_rank,
            "rel_rms_err": max(r["rel_rms_err"] for r in per_rank),
            "max_abs_err": max(r["max_abs_err"] for r in per_rank),
            "ref_rms": ref.pow(2).mean().sqrt().item(),
            "dp_seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="default 2; with --dp the config's full depth")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (a rehearsal of the script)")
    ap.add_argument("--decode", action="store_true",
                    help="compare the serving step (decode_step) instead")
    ap.add_argument("--dp", type=int, default=0,
                    help="compare the data-parallel forward on this many ranks instead")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    cfg = get_config("gemma_2b" if args.dp else "llama3_8b", smoke=args.smoke)
    if args.smoke and not args.dp:  # the smoke config's 2 KV heads, padded like CONFIG's 8
        cfg = dataclasses.replace(cfg, n_kv_heads_padded=args.tp)
    layers = args.layers or (cfg.n_layers if args.dp else 2)
    cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator().manual_seed(args.seed)
    shape = ((args.batch, args.prompt + args.steps) if args.decode
             else (args.batch, args.seq) if args.dp else (1, args.seq))
    tokens = torch.randint(0, cfg.vocab, shape, generator=gen)
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        row = (compare_dp(c, args.dp, args.seed + 1, tokens) if args.dp
               else (compare_decode if args.decode else compare)(
                   c, args.tp, args.seed + 1, tokens))
        print(json.dumps({"arch": cfg.name, "layers": layers, "tp": 0 if args.dp else args.tp,
                          "dp": args.dp, "decode": args.decode, "tokens": list(shape), **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
