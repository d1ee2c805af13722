#!/usr/bin/env python3
"""CPU emulation behind chip_smoke.py's tp_forward logit bounds.

chip_smoke.py runs llama3_8b at full width with 2 layers as Megatron TP on
4 gloo ranks, in bf16, and holds the gathered logits to the single-device
model's.  TP changes only the order of the row-parallel sums: each rank's
output projections give bf16 partial sums that the all_reduce adds, where
one device rounds one full-width sum.  This script makes the same
comparison on the CPU (gloo ranks over CPU tensors, the reference attention
path, the same seeds' kind of weights and tokens) and prints relative RMS
and max abs error, in bf16 and, as a control, in f32.

    python3 scripts/tp_logit_bounds.py [--layers 2] [--seq 1024] [--tp 4] [--smoke]

Full width needs about 4 GB of host memory per rank plus 4 GB for the
single-device model (llama3_8b's embedding and head are 0.5 G parameters
each); run it where the host has that to spare.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (a rehearsal of the script)")
    args = ap.parse_args()
    cfg = get_config("llama3_8b", smoke=args.smoke)
    if args.smoke:  # the smoke config's 2 KV heads, padded like CONFIG's 8
        cfg = dataclasses.replace(cfg, n_kv_heads_padded=args.tp)
    cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator().manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab, (1, args.seq), generator=gen)
    for dtype in ("bfloat16", "float32"):
        row = compare(dataclasses.replace(cfg, dtype=dtype), args.tp, args.seed + 1, tokens)
        print(json.dumps({"arch": cfg.name, "layers": args.layers, "tp": args.tp,
                          "tokens": [1, args.seq], **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
