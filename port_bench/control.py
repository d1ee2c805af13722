#!/usr/bin/env python3
"""Readings behind a cell's correctness limits, on the card.

    python3 port_bench/control.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 3] [--out FILE.jsonl]

For each seed, in one process, the comparison as ``run.py`` makes it (the
lower readings): the cell's set-up and a short window of its own traffic,
and the reference checks what that window produced.  On the control seeds
it also reads the control, the reference itself one precision below the
configuration's (float8 e4m3 products for bfloat16; the upper readings).  One JSON line a seed on standard output (and appended to
``--out``); the benchmark's own runs never run this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (sets up the paths and caches as a benchmark run)
import torch  # noqa: E402

import card  # noqa: E402
import check  # noqa: E402
import prefill  # noqa: E402
import spec  # noqa: E402


def free(device: str) -> None:
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()


def readings(cell, seed: int, seconds: float, control: bool, device: str) -> dict:
    t0 = time.perf_counter()
    m = cell.config["port"]
    model, params, pool = prefill.build(cell.config, device, seed)
    win = prefill.drive(model, params, pool, cell.traffic, seed, seconds, False, m["vocab"])
    f = prefill.facts(win, m, *card.memory(device))
    units = prefill.checked_units(win, seed)
    t1 = time.perf_counter()
    nums = prefill.reference_check(check.reference_module(cell.config), m, params, pool,
                                   units, control)
    out = {"seed": seed, "units": f["units"], "tokens_per_s": f["tokens"] / f["elapsed_s"],
           "checked": [[u[0], u[1]] for u in units], "set_up_and_window_s": t1 - t0,
           "reference_s": time.perf_counter() - t1, **nums}
    del model, params, pool, win
    free(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    run.build_kernels("cuda")
    print(json.dumps({"card": card.describe(), "torch": torch.__version__}), flush=True)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in map(int, args.seeds.split(",")):
        row = readings(cell, s, args.seconds, s in ctl, "cuda")
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
