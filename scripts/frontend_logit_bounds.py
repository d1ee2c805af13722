#!/usr/bin/env python3
"""CPU emulation behind chip_smoke.py's logit bounds for the frontend
prefills (hubert_xlarge, internvl2_26b).

On the card the prefill runs attention through the flash kernel, which
takes keys in tiles of 64 and rounds p to bf16 tile by tile, and is held to
the reference path, ``chunked_attention`` over chunks of 1024 keys.  This
script runs the reference path both ways on the CPU, with chunks of 64
keys (the kernel's tiles) and of 1024, from the same seeded weights and
inputs (``chip_smoke.draw_batch``: frames, or patches and tokens, named and
typed as ``input_specs`` gives them), and prints relative RMS and max abs
error of the logits, in bf16 and, as a control, in f32.

    python3 scripts/frontend_logit_bounds.py --arch hubert_xlarge [--layers N]
    python3 scripts/frontend_logit_bounds.py --arch internvl2_26b --layers 8 --batch 1
    python3 scripts/frontend_logit_bounds.py --arch internvl2_26b --device cuda --dtypes bfloat16
    python3 scripts/frontend_logit_bounds.py --arch hubert_xlarge --smoke   # rehearsal

hubert_xlarge at full width and depth needs about 2 GB of host memory in
bf16 (4 GB for the f32 control); internvl2_26b about 0.8 GB a layer in bf16
plus 2.3 GB for its embedding and head, twice that in f32, so run it with a
depth cut, where the host has that to spare, or at full depth in bf16 on
one H100 (``--device cuda``: the same two plain paths, on the card's
matrix products; no kernel of this repo runs).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import draw_batch  # noqa: E402  (also puts src/ on the path)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention  # noqa: E402


def forward(model, params, batch, chunk: int):
    """The reference path with attention over key chunks of ``chunk``."""
    plain = attention.chunked_attention
    attention.chunked_attention = functools.partial(plain, chunk=chunk)
    try:
        with torch.inference_mode():
            return model.forward(params, batch).float()
    finally:
        attention.chunked_attention = plain


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=("hubert_xlarge", "internvl2_26b"),
                    default="hubert_xlarge")
    ap.add_argument("--layers", type=int, default=None, help="default: the full depth")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (a rehearsal of the script)")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    args = ap.parse_args()
    cfg = get_config(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers)
    dev = torch.device(args.device)
    for dtype in args.dtypes.split(","):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = Model(c, impl="reference", device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(args.seed + 1))
        batch = draw_batch(c, torch.Generator(device=dev).manual_seed(args.seed), args.batch,
                           args.seq)
        t0 = time.perf_counter()
        tiles = forward(model, params, batch, 64)
        ref = forward(model, params, batch, 1024)
        diff = tiles - ref
        print(json.dumps({
            "arch": cfg.name, "layers": cfg.n_layers, "dtype": dtype, "device": str(dev),
            "inputs": {k: list(v.shape) for k, v in batch.items()},
            "rel_rms_err": (diff.norm() / ref.norm()).item(),
            "max_abs_err": diff.abs().max().item(),
            "ref_rms": ref.pow(2).mean().sqrt().item(),
            "finite": bool(torch.isfinite(tiles).all() and torch.isfinite(ref).all()),
            "seconds": time.perf_counter() - t0}), flush=True)
        del model, params
    return 0


if __name__ == "__main__":
    sys.exit(main())
