#!/usr/bin/env python3
"""K1's bf16 kernel built from several sources, timed in turns on one card.

Builds this tree's ``csrc/flash_attention.cu``, each ``--src`` (another
``flash_attention.cu`` with the same C interface, such as the parent's from
``git archive``) and each ``--variant NAME OLD NEW`` (this tree's source with
the text OLD replaced by NEW; a NAME given again takes one more edit) with
``build.py``'s flags into a library of
its own, all ``nvcc`` at once.  Then, for every main path's bf16 row of
``tests/card_cases.py``'s ``FA_CASES`` (head dims ``--dims``), it runs every
library on the same inputs, at the default softmax scale 1 / sqrt(D): each
output is held to the plain version within ``FA_TOL`` and
compared bit for bit with the first library's, and each library is timed
with ``chip_smoke.time_ms`` (a CUDA graph of 20 calls on rotated input
copies, replayed 5 times) in the order a b ... b a, so each reads twice.
SDPA's time is read once, in the middle.  Prints the card's name and power
limit, each library's ``flash_fwd_bf16`` registers, spills and ptxas notes,
and one JSON line per row.  Needs one H100.

    python3 scripts/flash_ab.py --src PARENT/src/repro_torch/kernels/csrc/flash_attention.cu
    python3 scripts/flash_ab.py --dims 256 --variant name 'old text' 'new text'
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]
import card_cases  # noqa: E402
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

OUT = build.BUILD / "ab"


def build_libs(sources: dict) -> dict:
    """name -> (library's path, nvcc log) for each name -> source text."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        digest = hashlib.sha256(text.encode()).hexdigest()[:16]
        cu, lib = OUT / f"{name}-{digest}.cu", OUT / f"{name}-{digest}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log[-4000:]}")
        out[name] = (lib, log)
    return out


def launcher(lib: Path):
    """``fa.flash_attention`` with its kernel taken from the library ``lib``."""
    kernel = dataclasses.replace(fa.KERNEL, lib=lib)

    def run(q, k, v, causal):
        with mock.patch.object(fa, "KERNEL", kernel):
            return fa.flash_attention(q, k, v, causal=causal)
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[], help="another flash_attention.cu")
    ap.add_argument("--variant", action="append", nargs=3, default=[],
                    metavar=("NAME", "OLD", "NEW"), help="this tree's source, OLD -> NEW")
    ap.add_argument("--dims", type=int, nargs="*", default=list(fa.HEAD_DIMS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device available", file=sys.stderr)
        return 1
    print(cs.card_name(), flush=True)
    tree = (build.CSRC / "flash_attention.cu").read_text()
    sources = {"tree": tree}
    for i, path in enumerate(args.src):
        sources[f"src{i}"] = Path(path).read_text()
    for name, old, new in args.variant:  # a name given again takes one more edit
        text = sources.get(name, tree)
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the text to replace occurs {text.count(old)} times")
        sources[name] = text.replace(old, new)
    libs = build_libs(sources)
    for name, (_, log) in libs.items():
        kernels = [f for f in cs.ptxas_report(log, {})
                   if f["function"].startswith("flash_fwd_bf16")]
        print(json.dumps({"library": name, "kernels": kernels}), flush=True)
    runs = {name: launcher(lib) for name, (lib, _) in libs.items()}
    order = list(runs) + list(runs)[::-1]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    with torch.inference_mode():
        for c in card_cases.FA_CASES:
            if c.path is None or c.dtype != torch.bfloat16 or c.D not in args.dims:
                continue
            B, Hq, Hkv, Sq, Sk, D, dt, causal, row, _ = c
            q, k, v = card_cases.fa_inputs(gen, c)
            ref = fa.flash_attention_plain(q, k, v, causal=causal)
            outs = {name: run(q, k, v, causal) for name, run in runs.items()}
            torch.cuda.synchronize()
            first = outs[order[0]]
            res = {"row": row, "shape": [B, Hq, Hkv, Sq, Sk, D], "causal": causal,
                   "max_abs_err": {n: card_cases.close(o, ref, card_cases.FA_TOL[dt])
                                   for n, o in outs.items()},
                   "equal_to_first": {n: bool(torch.equal(o, first)) for n, o in outs.items()},
                   "ms": {n: [] for n in runs}}
            for i, name in enumerate(order):
                if i == len(runs):
                    res["library_ms"] = cs.time_ms(lambda *a: F.scaled_dot_product_attention(
                        *a, is_causal=causal, enable_gqa=True), (q, k, v))
                res["ms"][name].append(cs.time_ms(
                    lambda *a, run=runs[name]: run(*a, causal), (q, k, v)))
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
