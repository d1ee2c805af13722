#!/usr/bin/env python3
"""Where a cold verdict of the port's verifier spends its seconds, on the CPU.

Runs what ``python -m repro_torch.verify <arch> --tp N`` runs, in one
process: the import of torch and of ``repro_torch.verify``, then the same
plan verified ``--runs`` times, each in a fresh ``Session`` (no cached
trace), printing each run's ``total_s``, ``trace_s`` and ``rules_s``: the
first run pays what the process has not loaded yet, the later ones the
steady state.  It counts the modules the first run imports, by package,
and with ``--profile`` puts the first run under ``cProfile`` and prints its
top functions by own time.  One JSON line per reading.

    python3 scripts/verify_cold_profile.py [--arch llama3_8b] [--tp 4] [--runs 3]
                                            [--profile] [--top 15]
"""
from __future__ import annotations

import argparse
import collections
import cProfile
import io
import json
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def package(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[:3]) if parts[0] == "torch" else parts[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    t0 = time.perf_counter()
    import torch  # noqa: F401

    t1 = time.perf_counter()
    from repro_torch.verify import Plan, Session

    t2 = time.perf_counter()
    print(json.dumps({"import_torch_s": t1 - t0, "import_repro_torch_verify_s": t2 - t1}))
    for run in range(args.runs):
        before = set(sys.modules)
        prof = cProfile.Profile() if args.profile and run == 0 else None
        with Session() as session:
            if prof is not None:
                prof.enable()
            rep = session.verify(args.arch, Plan(tp=args.tp))
            if prof is not None:
                prof.disable()
        t = rep.timings
        row = {"run": run, "verified": rep.verified, "total_s": rep.elapsed_s,
               "trace_s": t.trace_s, "stamp_s": t.stamp_s, "rules_s": t.rules_s,
               "profiled": prof is not None}
        if run == 0:
            new = collections.Counter(package(m) for m in set(sys.modules) - before)
            row["modules_imported"] = sum(new.values())
            row["by_package"] = dict(new.most_common(12))
        print(json.dumps(row), flush=True)
        if prof is not None:
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(args.top)
            print(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
