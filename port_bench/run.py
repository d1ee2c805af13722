#!/usr/bin/env python3
"""Run one cell of the PyTorch port's benchmark once, on the card.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic; the pieces are found by name (``spec.py``)
and the traffic's ``kind`` picks the driver (``prefill.py``).
Set-up (the kernels' build, the weights and inputs drawn on the card from
the seed, one warm-up of each shape) is timed from the start of this
process to the window's first unit of work.  With ``--trace 1`` the
untraced window is followed by traced segments (``prefill.drive``); the
per-layer metrics timed by the host's clock read the untraced window.
After the window the memory peak is read, and the program's outputs are
compared with the plain float32 reference (``reference/``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown`` and ``tokens_per_s_by_segment``, ``card_state`` (clocks, power and clock-event reasons
before and after the window), and last ``checks``: each compared number
beside its limit, also printed as the last lines of standard error.  Without a CUDA device,
or with fewer than the cell asks for, it exits 2 and prints no result; it
exits 3 if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the program's kernel caches stay inside the checkout, at fixed paths (the
# nvcc libraries go to src/repro_torch/kernels/build/ by the program's own
# rule)
os.environ["TRITON_CACHE_DIR"] = str(HERE / "cache" / "triton")
sys.path[:0] = [str(HERE), str(ROOT / "src")]

import torch  # noqa: E402

import card  # noqa: E402
import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def build_kernels(device: str) -> float:
    """Build the program's CUDA kernels (a no-op where the checkout holds
    them); returns the seconds it took."""
    if not device.startswith("cuda"):
        return 0.0
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    return time.perf_counter() - t0


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
             t_start: float, root: Path = ROOT) -> dict:
    """One run of ``cell``: its result line as a dict."""
    build_s = build_kernels(device)
    driver = importlib.import_module(cell.traffic["kind"])
    facts, numbers = driver.run(cell, seed, seconds, traced, device, t_start)
    entries = cell.per_layer if traced else cell.end_to_end
    metrics = spec.read_metrics(entries, facts, root)
    correct = all(numbers[k] <= lim for k, lim in cell.limits.items()) and bool(cell.limits)
    dev = {"platform": "gpu" if device.startswith("cuda") else device,
           "kind": torch.cuda.get_device_name() if device.startswith("cuda") else device,
           "count": cell.chips, "memory_peak_bytes": facts["peak_bytes"]}
    out = {"correct": correct, "attempted": facts["requests"],
           "failed": 0 if correct else facts["checked"],
           "metrics": metrics, "device": dev, "build_s": build_s,
           "setup_phases": facts.get("setup_phases")}
    out["card_state"] = facts.get("card")
    if traced:
        tr = facts["trace"]
        dev.update(busy_s=facts["busy"]["busy_s"], window_s=facts["busy"]["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        out["trace_reduce_s"] = tr["reduce_s"]
        out["tokens_per_s_by_segment"] = facts["tokens_per_s_by_segment"]
    out["checks"] = {k: {"value": numbers[k], "limit": lim} for k, lim in cell.limits.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    if not cell.limits:
        print(f"no limits for {args.workload}: port_bench/limits/{args.workload}.json",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    out["card"] = card.describe()
    checks = out.pop("checks")
    out["checks"] = checks
    leaked = forbidden_modules()
    if leaked:
        print(f"JAX or the JAX package was loaded: {leaked}", file=sys.stderr)
        return 3
    print(f"card {json.dumps(out['card_state'])}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
