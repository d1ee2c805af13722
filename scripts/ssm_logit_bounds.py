#!/usr/bin/env python3
"""CPU emulation behind ``chip_smoke.py``'s mamba2_130m logit bounds.

Runs mamba2_130m at full width and depth in bf16 on the CPU, with random
weights from a seeded generator and ``dt_bias``/``A_log`` redrawn as
Mamba-2 initializes them (``chip_smoke.init_mamba2``), and prints three
differences, each as relative RMS error and max abs error of the logits:

- prefill: the kernel path (``ssd_scan_plain`` on the CPU) against the
  reference path (``ssd_chunked``), batch (1, 512): four chunks of 128;
- decode: the kernel-path prefill of a 256-token sequence (two chunks)
  against 256 ``decode_step`` calls, at every position;
- the prefill difference again with the model in f32, which shows what
  bf16's roundings add to f32's summation order.

Usage (from the repository root; about 25 s on 8 cores):

    python3 scripts/ssm_logit_bounds.py
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import init_mamba2  # noqa: E402  (puts src/ on the path)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402


def diff(out: torch.Tensor, ref: torch.Tensor) -> dict:
    out, ref = out.float(), ref.float()
    return {"rel_rms_err": ((out - ref).norm() / ref.norm()).item(),
            "max_abs_err": (out - ref).abs().max().item(),
            "ref_rms": ref.pow(2).mean().sqrt().item()}


def prefill_diff(cfg, gen: torch.Generator) -> tuple:
    model = Model(cfg, device="cpu")
    params = init_mamba2(model, gen)
    tokens = torch.randint(0, cfg.vocab, (1, 512), generator=gen)
    kern = model.prefill(params, {"tokens": tokens})
    ref = Model(cfg, impl="reference", device="cpu").forward(params, {"tokens": tokens})
    print(json.dumps({"check": "prefill kernel path vs reference path", "dtype": cfg.dtype,
                      "batch": list(tokens.shape), **diff(kern, ref)}), flush=True)
    return model, params, tokens


def main() -> int:
    cfg = get_config("mamba2_130m")
    with torch.inference_mode():
        model, params, tokens = prefill_diff(cfg, torch.Generator().manual_seed(0))
        seq = tokens[:, :256]
        pre = model.prefill(params, {"tokens": seq})[0]
        caches = model.init_cache(1, 256)
        steps = []
        for pos in range(seq.shape[1]):
            logits, caches = model.decode_step(params, seq[:, pos], caches, pos)
            steps.append(logits[0])
        print(json.dumps({"check": "prefill vs decode_step, every position",
                          "tokens": seq.shape[1], **diff(torch.stack(steps), pre)}),
              flush=True)
        prefill_diff(dataclasses.replace(cfg, dtype="float32"),
                     torch.Generator().manual_seed(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
