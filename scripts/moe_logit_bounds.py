#!/usr/bin/env python3
"""Emulation behind chip_smoke.py's MoE logit bounds (``MOE_BOUNDS``).

Prefill: on the card the MoE prefill runs attention through the flash
kernel, which takes keys in tiles of 64 and rounds p to bf16 tile by tile,
and is held to the reference path, ``chunked_attention`` over chunks of
1024 keys; both run the same capacity dispatch.  This script runs the
reference path both ways, with chunks of 64 keys and of 1024, from the
same seeded weights and tokens, and prints relative RMS and max abs error
of the logits, over every token and over the tokens the two route alike
(equal top-k expert sets in every MoE layer), the tokens routed
differently somewhere, the token-layers whose top-k sets differ (and their
share of all token-layers) and the
pairs each dropped, in bf16 and, as a control, in f32: the three limits of
chip_smoke.py's ``MOE_BOUNDS``.

TP (``--tp N``): chip_smoke.py runs granite_moe_3b's execution program on
N gloo ranks (experts split over the ranks) against the single device.
This script makes the same comparison through the reference path
(``spmd.tp_forward``) and prints the same readings (rank 0's routing
against the single device's), the pairs each rank's experts dropped and
the single device's.

    python3 scripts/moe_logit_bounds.py [--arch granite_moe_3b] [--layers N] [--device cuda]
    python3 scripts/moe_logit_bounds.py --arch mixtral_8x7b --layers 8 --device cuda
    python3 scripts/moe_logit_bounds.py --arch moonshot_v1_16b --device cuda --dtypes bfloat16
    python3 scripts/moe_logit_bounds.py --tp 4 --layers 4 [--device cuda]
    python3 scripts/moe_logit_bounds.py --smoke            # rehearsal, on the CPU

granite_moe_3b at full width and depth holds 6.3 GiB of bf16 weights
(twice that for the f32 control, and a transient f32 copy of one expert
stack while they are drawn); mixtral_8x7b about 2.8 GiB a layer in bf16
plus a 14 GiB f32 draw of one expert stack at 8 layers; moonshot_v1_16b
53.8 GiB in bf16 (its expert stacks drawn a block at a time), so no f32
control fits on an 80 GB card beside it: run it with ``--dtypes
bfloat16``.  Run them on the card (``--device cuda``: plain paths on the
card's matrix products; no kernel of this repo runs) or where the host has
that to spare.
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
from chip_smoke import flipped_tokens, topk_flips  # noqa: E402  (puts src/ on the path)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention, mlp  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402


def forward(model, params, tokens, chunk: int):
    """The reference path with attention over key chunks of ``chunk``, and
    its routing."""
    plain = attention.chunked_attention
    attention.chunked_attention = functools.partial(plain, chunk=chunk)
    try:
        with torch.inference_mode(), mlp.record_routing() as routing:
            return model.forward(params, {"tokens": tokens}).float(), routing
    finally:
        attention.chunked_attention = plain


def errors(got, want, got_idx: list, want_idx: list) -> dict:
    """The readings behind MOE_BOUNDS, for logits (B, S, V) and the two
    runs' routings."""
    diff = got - want
    flipped = flipped_tokens(got_idx, want_idx).to(got.device)
    flips = sum(int(topk_flips(a, b.to(a.device))) for a, b in zip(got_idx, want_idx))
    sd, sw = diff.reshape(-1, diff.shape[-1])[~flipped], want.reshape(-1, diff.shape[-1])[~flipped]
    return {"rel_rms_err": (diff.norm() / want.norm()).item(),
            "max_abs_err": diff.abs().max().item(),
            "stable_rel_rms_err": (sd.norm() / sw.norm()).item(),
            "stable_max_abs_err": sd.abs().max().item(),
            "flipped_tokens": int(flipped.sum()), "topk_set_flips": flips,
            "flip_share": flips / (len(got_idx) * got_idx[0].shape[0]),
            "ref_rms": want.pow(2).mean().sqrt().item(),
            "finite": bool(torch.isfinite(got).all() and torch.isfinite(want).all())}


def prefill(cfg, dev, seed: int, shape) -> dict:
    model = Model(cfg, impl="reference", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed + 1))
    tokens = torch.randint(0, cfg.vocab, shape, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    tiles, rt = forward(model, params, tokens, 64)
    ref, rr = forward(model, params, tokens, 1024)
    return {**errors(tiles, ref, [r["idx"] for r in rt], [r["idx"] for r in rr]),
            "capacity": mlp.moe_capacity(cfg, shape[0] * shape[1]),
            "dropped_pairs": sum(int(r["dropped"]) for r in rt),
            "reference_dropped_pairs": sum(int(r["dropped"]) for r in rr)}


def tp(cfg, dev, seed: int, shape, size: int) -> dict:
    tokens = torch.randint(0, cfg.vocab, shape,
                           generator=torch.Generator().manual_seed(seed))
    model = Model(cfg, impl="reference", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed + 1))
    with torch.inference_mode(), mlp.record_routing() as routing:
        ref = model.forward(params, {"tokens": tokens.to(dev)}).float().cpu()
        dropped = sum(int(r["dropped"]) for r in routing)
        ref_idx = [r["idx"].cpu() for r in routing]
    del model, params
    ranks = spmd.run(spmd.tp_forward, size,
                     (cfg, seed + 1, tokens, "reference", str(dev)), timeout=1800)
    got = torch.cat([r["logits"] for r in ranks], dim=-1).float()
    return {**errors(got, ref, ranks[0]["topk"], ref_idx),
            "dropped_pairs_per_rank": [r["dropped"] for r in ranks],
            "single_device_dropped_pairs": dropped}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=("granite_moe_3b", "mixtral_8x7b", "moonshot_v1_16b"),
                    default="granite_moe_3b")
    ap.add_argument("--layers", type=int, default=None, help="default: the full depth")
    ap.add_argument("--tp", type=int, default=0, help="compare TP on this many gloo ranks")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 2 for the prefill, 1 for TP, as on the card")
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
    shape = (args.batch or (1 if args.tp else 2), args.seq)
    for dtype in args.dtypes.split(","):
        c = dataclasses.replace(cfg, dtype=dtype)
        t0 = time.perf_counter()
        out = tp(c, dev, args.seed, shape, args.tp) if args.tp else prefill(
            c, dev, args.seed, shape)
        print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers, "dtype": dtype,
                          "device": str(dev), "tp": args.tp or None, "tokens": list(shape),
                          **out, "seconds": time.perf_counter() - t0}), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
