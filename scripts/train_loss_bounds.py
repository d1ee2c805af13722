#!/usr/bin/env python3
"""The reading behind chip_smoke.py's TRAIN_LOSS_BOUND: the trainer's first
loss against the kernel path's, for the same weights and batch.

The trainer differentiates ``Model.loss`` on ``impl="reference"`` (the
kernels have no backward); the kernel path runs the same loss through K1
under ``inference_mode``.  The two differ only in how attention's bf16
products are rounded and summed.  For each seed this script draws qwen3_4b's
weights and a SyntheticLM batch from it, as chip_smoke.py's train phase does
for its seed, takes the trainer's loss (``local_grads``, what the first
train step computes) and the kernel path's, and prints both and their
absolute and relative difference, then the largest over the seeds and 3x
it, the bound chip_smoke.py takes.

    python3 scripts/train_loss_bounds.py                 # full width, on the card
    python3 scripts/train_loss_bounds.py --smoke --device cpu   # rehearsal

On the CPU the kernel path is the kernels' plain versions, so a CPU run
only rehearses the script; full width runs only on the card (9.2 GB of
bf16 weights, as many of gradients).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train.trainer import TrainConfig, local_grads  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    if args.device == "cpu" and not args.smoke:
        print("full width runs on the card only; pass --smoke to rehearse on the CPU")
        return 2
    cfg = get_config(args.arch, smoke=args.smoke)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    worst = 0.0
    for seed in args.seeds:
        model = Model(cfg, impl="reference", device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        batch = tree_map(lambda t: t.to(dev), SyntheticLM(
            DataConfig(cfg.vocab, args.seq, args.batch, seed=seed)).batch_at(0))
        trainer = float(local_grads(model, TrainConfig(remat=False), params, batch)[0])
        with torch.inference_mode():
            kernel = float(Model(cfg, impl="kernel", device=dev).loss(params, batch))
        diff = abs(trainer - kernel)
        worst = max(worst, diff)
        print(json.dumps({"arch": cfg.name, "seed": seed, "dtype": cfg.dtype,
                          "batch": [args.batch, args.seq], "device": str(dev),
                          "trainer_loss": trainer, "kernel_path_loss": kernel,
                          "abs_diff": diff, "rel_diff": diff / abs(trainer)}), flush=True)
        del model, params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"max_abs_diff": worst, "bound_3x": 3 * worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
