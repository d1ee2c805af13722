"""Verify the port's own TP-16 parallelization of every architecture in the
zoo (the paper's Table 2 workload) through ONE warm ``Session``.

Each arch is verified twice: the first (cold) call traces and fingerprints;
the second (warm) call is served from the session's trace and template
caches (``Report.cache.trace_cached`` / ``fp_cached`` prove the reuse).  The
summary prints the per-arch cold/warm speedup.

    PYTHONPATH=src python -m repro_torch.examples.verify_model_zoo [--layers 2] [--tp 16]
"""
import argparse
import time

from repro_torch.configs.base import ARCH_IDS
from repro_torch.verify import Plan, Session


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--tp", type=int, default=16)
    args = ap.parse_args(argv)

    print(f"{'arch':18s} {'verified':9s} {'facts':>6s} {'memo':>5s} "
          f"{'cold':>7s} {'warm':>7s} {'speedup':>8s}")
    speedups = []
    with Session() as session:
        for arch in ARCH_IDS:
            plan = Plan(tp=args.tp, layers=args.layers, seq=32)
            t0 = time.time()
            cold = session.verify(arch, plan)
            t_cold = time.time() - t0
            t0 = time.time()
            warm = session.verify(arch, plan)
            t_warm = time.time() - t0
            assert warm.cache.trace_cached and warm.cache.fp_cached > 0, (
                f"{arch}: warm call did not hit the session caches")
            assert warm.verified == cold.verified
            speedups.append(t_cold / max(t_warm, 1e-9))
            print(f"{arch:18s} {str(cold.verified):9s} {cold.num_facts:6d} "
                  f"{cold.cache.memo_hits:5d} {t_cold:6.2f}s {t_warm:6.2f}s "
                  f"{speedups[-1]:7.1f}x")
            if not cold.verified:
                for b in cold.bug_sites[:3]:
                    print(f"   [{b.severity}/{b.category}] {b.op} at {b.src}")

    gm = 1.0
    for s in speedups:
        gm *= s
    gm **= 1.0 / max(len(speedups), 1)
    print(f"\nwarm-session speedup (geomean over {len(speedups)} archs): {gm:.1f}x")


if __name__ == "__main__":
    main()
