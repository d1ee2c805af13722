#!/usr/bin/env python3
"""Where the bf16 SSD scan kernel's time goes, by ablation, on one H100.

Builds copies of ``csrc/ssd_scan.cu`` with one or more of the scan kernel's
per-chunk products switched off (their loops skipped), times each copy and
the intact kernel at the mamba2_130m prefill shape (4, 4096, 32, 64, N=128,
chunk 128, bf16, Mamba-2's dt and A: ``card_cases.ssd_inputs``) with
``chip_smoke.time_ms``, and prints
one JSON line.  A switched-off product's time is the intact kernel's minus
that copy's; the copies compute wrong outputs and are only timed.

    python3 scripts/ssd_scan_breakdown.py
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))
import card_cases  # noqa: E402
import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

SHAPE = (4, 4096, 32, 64, 128)  # B, S, H, P, N
CHUNK = 128
# (text of csrc/ssd_scan.cu, its replacement): each skips one product's loop
M_X = ("      if (ib >= nj) return;  // rows past q", "      if (ib >= 0) return;")
C_STATE = ("        if (kb0 < nk) {", "        if (kb0 < 0) {")
UPDATE = ("        if (jb0 < nj) {", "        if (jb0 < 0) {")
SCAN_OFF = ("  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;\n",
            "  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;\n"
            "  if (S > 0) return;\n")
VARIANTS = {"no_m_x": [M_X], "no_c_state": [C_STATE], "no_update": [UPDATE],
            "no_products": [M_X, C_STATE, UPDATE], "chunk_products_only": [SCAN_OFF]}


def build_variants(tmp: Path) -> dict[str, Path]:
    src = (build.CSRC / "ssd_scan.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} occurs {text.count(old)} times")
            text = text.replace(old, new)
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log[-2000:]}")
    return {name: tmp / f"{name}.so" for name in VARIANTS}


def launcher(lib_path: Path):
    """``ssd.ssd_scan`` with its scan kernel taken from the copy at
    ``lib_path`` (the copies skip loops only: the intact library's
    workspace size holds)."""
    kernel = dataclasses.replace(ssd.KERNEL, lib=lib_path)

    def run(*args):
        with mock.patch.object(ssd, "KERNEL", kernel):
            return ssd.ssd_scan(*args, chunk=CHUNK)
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_scan_breakdown: no CUDA device available", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    args = card_cases.ssd_inputs(gen, card_cases.SSD(*SHAPE, CHUNK, torch.bfloat16, "mamba2"))
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        libs = build_variants(Path(tmp))
        ms = {"intact": chip_smoke.time_ms(lambda *a: ssd.ssd_scan(*a, chunk=CHUNK), args)}
        for name, path in libs.items():
            ms[name] = chip_smoke.time_ms(launcher(path), args)
    share = {"m_x": ms["intact"] - ms["no_m_x"], "c_state": ms["intact"] - ms["no_c_state"],
             "update": ms["intact"] - ms["no_update"],
             "rest_of_scan": ms["no_products"] - ms["chunk_products_only"],
             "chunk_products": ms["chunk_products_only"]}
    print(json.dumps({"shape": list(SHAPE), "chunk": CHUNK, "device":
                      torch.cuda.get_device_name(0), "ms": ms, "ms_by_part": share}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
