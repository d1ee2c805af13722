"""Command-line verification gate of the port (the JAX package's CLI, with
graphs traced from the torch models).

    python -m repro_torch.verify <arch> --tp 4 [--decode | --sp | --pipeline K]
                                 [--dp N] [--composite] [--layers N]
                                 [--json out.json|-] [--cache-dir DIR]
    python -m repro_torch.verify <arch> --dp 2 [--grad]
    python -m repro_torch.verify <moe arch> --ep 4
    python -m repro_torch.verify --list
    python -m repro_torch.verify --list-injectors
    python -m repro_torch.verify campaign --arch llama3_8b --tp 4 [--seeds N]
    python -m repro_torch.verify lint --arch gemma_2b --tp 4 [--passes ...] [--json -]
    python -m repro_torch.verify rulecheck [--ops-from ARCH] [--json -]

The ``campaign`` verb runs the detection-benchmark matrix
(:mod:`repro_torch.verify.campaign`): every registered injector x every
applicable scenario x every ``--arch``, plus ``--seeds`` fuzzer seeds;
exit 1 on any missed detection or clean-cell false positive.

Every scenario of the JAX package is ported: ``tp-forward``, ``tp-decode``
(``--decode``), ``sp-forward`` (``--sp``), ``dp-forward`` (``--dp``),
``dp-grad`` (``--grad``), ``ep-moe-forward`` (``--ep``), ``stage``
(``--pipeline``) and ``tpdp-forward`` (``--composite``).  So is the lint
tier: ``--lint`` (a baseline-free preflight over each scenario's
distributed graph, attached as ``Report.lint``), the ``lint`` verb (single
traced graphs, no golden pair) and the ``rulecheck`` verb (the rule
registry's producer/consumer matrix).

Exit codes (stable contract for CI and launcher scripts):

    0  plan verified / campaign clean
    1  plan NOT verified (bug sites) / campaign missed a bug or false-flagged
    2  usage error (unknown arch/scenario/injector, invalid plan, bad flags)
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from repro_torch.configs.base import ARCH_IDS, EXTRA_IDS

from .plan import Plan, PlanError
from .session import Session

EXIT_VERIFIED = 0
EXIT_UNVERIFIED = 1
EXIT_USAGE = 2


class _Parser(argparse.ArgumentParser):
    def error(self, message: str):  # argparse default exits 2 — keep that
        self.print_usage(sys.stderr)
        raise SystemExit(EXIT_USAGE)


def build_parser() -> argparse.ArgumentParser:
    ap = _Parser(
        prog="python -m repro_torch.verify",
        description="Verify a model's parallelization plan "
                    "(graph equivalence, paper-style).")
    ap.add_argument("arch", nargs="?", default=None,
                    help="architecture id (repro_torch.configs)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and known archs, then exit")
    ap.add_argument("--list-injectors", action="store_true",
                    help="list registered bug injectors, then exit")
    ap.add_argument("--tp", type=int, default=None, help="tensor-parallel degree")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel degree")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel degree (MoE archs: verifies the "
                         "expert axis via the unrolled expert-slice loop)")
    ap.add_argument("--sp", action="store_true",
                    help="sequence parallelism: verify the reduce_scatter/"
                         "all_gather forward instead of the psum forward")
    ap.add_argument("--composite", action="store_true",
                    help="with --tp and --dp: also verify the tp x dp "
                         "2D program against the 1D TP program")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--decode", action="store_true",
                      help="verify the serving decode step (tp axis)")
    mode.add_argument("--grad", action="store_true",
                      help="verify DP gradient sync (dp axis)")
    mode.add_argument("--pipeline", type=int, metavar="STAGES", default=0,
                      help="verify each pipeline stage (per-stage tp)")
    ap.add_argument("--layers", type=int, default=None,
                    help="layer-count override (rounded to block periods)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=64, help="decode cache length")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--engine", choices=("worklist", "passes"),
                    default="worklist")
    ap.add_argument("--workers", type=int, default=0,
                    help="parallel rewriting workers (0 = serial)")
    ap.add_argument("--backend", choices=("auto", "thread", "process"),
                    default="auto",
                    help="shard backend for --workers > 1: 'process' ships "
                         "picklable work units to a worker-process pool "
                         "(true parallelism), 'thread' uses the in-process "
                         "overlay sweep, 'auto' picks process when fork is "
                         "available")
    ap.add_argument("--profile", action="store_true",
                    help="collect per-rule / per-op-family timings into the "
                         "report (timings.profile) and print the top rules")
    ap.add_argument("--no-fusion", action="store_true",
                    help="disable the equality-saturation fusion tier "
                         "(falls back to the legacy rule registry with the "
                         "retired congruence rules)")
    ap.add_argument("--no-stamp", action="store_true",
                    help="disable layer stamping (full trace)")
    ap.add_argument("--cache-dir", metavar="DIR", default=None,
                    help="persistent warm-start cache directory "
                         "(repro_torch.verify.store): traced pairs and per-layer "
                         "templates survive the process, so a fresh run of "
                         "a previously-seen (arch, plan) skips tracing "
                         "and memo-replays every layer. Defaults to "
                         "$REPRO_CACHE_DIR when set")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore --cache-dir / $REPRO_CACHE_DIR (cold run)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report ('-' = stdout)")
    ap.add_argument("--inject", metavar="INJECTOR[:INDEX]", default=None,
                    help="inject a bug into the distributed graph first "
                         "(testing/demo; see repro_torch.core.inject). INDEX "
                         "selects the mutation site and defaults to 1 — the "
                         "first layer collective rather than the embedding "
                         "region (same convention as the bug benchmarks)")
    ap.add_argument("--lint", action="store_true",
                    help="also run the baseline-free lint tier over each "
                         "scenario's distributed graph (Report.lint); the "
                         "verdict is unaffected")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human-readable summary")
    return ap


def _plan_of(args) -> Plan:
    # every axis flag is passed through so contradictory combinations
    # (e.g. --decode --dp 8, --decode --sp) fail Plan validation with exit 2
    # instead of silently dropping an axis the user asked to verify
    kw = dict(dp=args.dp, ep=args.ep, sp=args.sp, composite=args.composite,
              layers=args.layers, batch=args.batch, seq=args.seq,
              max_len=args.max_len, smoke=args.smoke)
    tp = args.tp if args.tp is not None else 1
    if args.decode:
        return Plan.decode(tp=tp, **kw)
    if args.grad:
        return Plan(tp=tp, mode="grad", **kw)
    if args.pipeline:
        # per-stage TP defaults to 2 when --tp is omitted; an explicit
        # --tp 1 is the user's plan and fails Plan validation (exit 2)
        return Plan.pipeline(stages=args.pipeline,
                             tp=tp if args.tp is not None else 2, **kw)
    return Plan(tp=tp, **kw)


def ported_archs() -> list[str]:
    """Known archs whose config module the port has."""
    import importlib.util

    return sorted(a for a in set(ARCH_IDS) | set(EXTRA_IDS)
                  if importlib.util.find_spec(f"repro_torch.configs.{a}"))


def _print_list() -> None:
    from repro_torch.analysis import DEFAULT_LINTS
    from repro_torch.core.inject import DEFAULT_INJECTORS

    from .scenarios import DEFAULT_SCENARIOS

    print("registered scenarios:")
    for line in DEFAULT_SCENARIOS.describe().splitlines():
        print(f"  {line}")
    print("\nregistered injectors:")
    for line in DEFAULT_INJECTORS.describe().splitlines():
        print(f"  {line}")
    print("\nregistered lint passes:")
    for line in DEFAULT_LINTS.describe().splitlines():
        print(f"  {line}")
    print("\nported archs:")
    print("  " + " ".join(ported_archs()))


def _injector_of(spec: str):
    from repro_torch.core.inject import DEFAULT_INJECTORS

    name, _, idx = spec.partition(":")
    inj_spec = DEFAULT_INJECTORS.get(name)  # InjectorError -> exit 2
    index = int(idx) if idx else 1

    def mutate(gd):
        inj = inj_spec(gd, index=index)
        if inj is None and not idx:
            inj = inj_spec(gd)  # default index only: fall back to first site
        if inj is None:
            raise PlanError(
                f"injector {name!r} found no site at index {index}")
        return inj.graph

    return mutate


def build_campaign_parser() -> argparse.ArgumentParser:
    ap = _Parser(
        prog="python -m repro_torch.verify campaign",
        description="Detection-benchmark campaign: injector registry x "
                    "scenario matrix x fuzzer seeds (paper Tables 4/5 as a "
                    "regression gate).")
    ap.add_argument("--arch", action="append", default=None,
                    help="architecture id (repeatable; repro_torch.configs)")
    ap.add_argument("--tp", type=int, default=4,
                    help="tensor-parallel degree for tp/sp/ep scenarios")
    ap.add_argument("--dp", type=int, default=2,
                    help="data-parallel degree for dp scenarios")
    ap.add_argument("--layers", type=int, default=2,
                    help="layer-count override per scenario")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated scenario subset (default: all "
                         "applicable)")
    ap.add_argument("--injectors", default=None,
                    help="comma-separated injector subset (default: the "
                         "whole registry)")
    ap.add_argument("--seeds", type=int, default=0,
                    help="number of fuzzer seeds to sweep (seed-base..+N)")
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--fuzz-only", action="store_true",
                    help="skip the arch matrix, run only the fuzzer seeds")
    ap.add_argument("--engine", choices=("worklist", "passes"),
                    default="worklist")
    ap.add_argument("--no-stamp", action="store_true")
    ap.add_argument("--no-fusion", action="store_true",
                    help="disable the equality-saturation fusion tier")
    ap.add_argument("--cache-dir", metavar="DIR", default=None,
                    help="persistent warm-start cache shared by the "
                         "campaign's cells (clean pairs trace once per "
                         "scenario and survive across campaign runs). "
                         "Defaults to $REPRO_CACHE_DIR when set")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore --cache-dir / $REPRO_CACHE_DIR (cold run)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the detection-matrix report ('-' = stdout)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def _cache_dir_of(args) -> Optional[str]:
    import os

    if args.no_cache:
        return None
    return args.cache_dir or os.environ.get("REPRO_CACHE_DIR") or None


def campaign_main(argv: Optional[list] = None) -> int:
    from repro_torch.core.inject import InjectorError
    from repro_torch.core.verifier import VerifyOptions

    from .campaign import run_campaign

    args = build_campaign_parser().parse_args(argv)
    archs = args.arch or []
    if not archs and not args.fuzz_only:
        print("error: campaign needs at least one --arch (or --fuzz-only)",
              file=sys.stderr)
        return EXIT_USAGE
    known = set(ARCH_IDS) | set(EXTRA_IDS)
    for a in archs:
        if a not in known:
            print(f"error: unknown arch {a!r} "
                  f"(known: {', '.join(sorted(known))})", file=sys.stderr)
            return EXIT_USAGE
    scenarios = args.scenarios.split(",") if args.scenarios else None
    injectors = args.injectors.split(",") if args.injectors else None
    seeds = tuple(range(args.seed_base, args.seed_base + args.seeds))
    options = VerifyOptions(engine=args.engine, stamp=not args.no_stamp,
                            fusion=not args.no_fusion)
    try:
        report = run_campaign(
            [] if args.fuzz_only else archs,
            tp=args.tp, dp=args.dp, layers=args.layers, seq=args.seq,
            scenarios=scenarios, injectors=injectors, fuzz_seeds=seeds,
            options=options, cache_dir=_cache_dir_of(args))
    except (PlanError, InjectorError) as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_USAGE

    summary_stream = sys.stdout
    if args.json == "-":
        print(report.to_json(indent=2))
        summary_stream = sys.stderr
    elif args.json:
        with open(args.json, "w") as fh:
            fh.write(report.to_json(indent=2) + "\n")
    if not args.quiet:
        print(report.summary(), file=summary_stream)
    return EXIT_VERIFIED if report.ok else EXIT_UNVERIFIED


def _print_injectors() -> None:
    from repro_torch.core.inject import DEFAULT_INJECTORS

    print("registered injectors:")
    for line in DEFAULT_INJECTORS.describe().splitlines():
        print(f"  {line}")


def build_lint_parser() -> argparse.ArgumentParser:
    ap = _Parser(
        prog="python -m repro_torch.verify lint",
        description="Baseline-free static analysis over single traced "
                    "graphs: IR well-formedness + sharding-semantics lints "
                    "(no golden pair required).")
    ap.add_argument("--arch", action="append", default=None,
                    help="architecture id (repeatable; 'all' = the full zoo)")
    ap.add_argument("--tp", type=int, action="append", default=None,
                    help="tensor-parallel degree (repeatable; default 1)")
    ap.add_argument("--sp", action="store_true",
                    help="lint the sequence-parallel forward (tp > 1 only)")
    ap.add_argument("--layers", type=int, default=2,
                    help="layer-count override (rounded to block periods)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (tp=1 only: smoke head counts "
                         "break tp divisibility)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated lint-pass subset (default: all; "
                         "unknown names exit 2 listing the registered set)")
    ap.add_argument("--inject", metavar="INJECTOR[:INDEX]", default=None,
                    help="inject a bug into the traced graph before linting "
                         "(testing/demo; same convention as the verify verb)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable lint report ('-' = stdout)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human-readable summary")
    return ap


def lint_main(argv: Optional[list] = None) -> int:
    from repro_torch.analysis import (DEFAULT_LINTS, LintError, LintReport,
                                run_lints, trace_lint_unit, unit_context)
    from repro_torch.core.inject import InjectorError

    args = build_lint_parser().parse_args(argv)
    archs = args.arch or []
    if "all" in archs:
        archs = [a for a in archs if a != "all"] + list(ARCH_IDS)
    archs = list(dict.fromkeys(archs))  # dedupe, keep order
    if not archs:
        print("error: lint needs at least one --arch ('all' = the zoo)",
              file=sys.stderr)
        return EXIT_USAGE
    known = set(ARCH_IDS) | set(EXTRA_IDS)
    for a in archs:
        if a not in known:
            print(f"error: unknown arch {a!r} "
                  f"(known: {', '.join(sorted(known))})", file=sys.stderr)
            return EXIT_USAGE
    tps = args.tp or [1]
    passes = ([p for p in args.passes.split(",") if p]
              if args.passes else None)
    try:
        if passes:
            DEFAULT_LINTS.resolve(passes)  # unknown pass -> exit 2, listed
        mutate = _injector_of(args.inject) if args.inject else None
        merged = LintReport()
        for arch in archs:
            for tp in tps:
                unit = trace_lint_unit(arch, tp, sp=args.sp,
                                       layers=args.layers, batch=args.batch,
                                       seq=args.seq, smoke=args.smoke)
                if mutate is not None:
                    unit = unit.mutate(mutate)
                merged = merged.merge(
                    run_lints(unit_context(unit), passes=passes))
    except (LintError, PlanError, InjectorError) as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_USAGE
    except ValueError as e:
        print(f"error: trace invalid for requested plan: {e}",
              file=sys.stderr)
        return EXIT_USAGE

    summary_stream = sys.stdout
    if args.json == "-":
        print(merged.to_json(indent=2))
        summary_stream = sys.stderr  # keep stdout pure JSON
    elif args.json:
        with open(args.json, "w") as fh:
            fh.write(merged.to_json(indent=2) + "\n")
    if not args.quiet:
        print(merged.summary(), file=summary_stream)
    return EXIT_VERIFIED if merged.ok else EXIT_UNVERIFIED


def build_rulecheck_parser() -> argparse.ArgumentParser:
    ap = _Parser(
        prog="python -m repro_torch.verify rulecheck",
        description="Static checker for the rule registry: dead rules, "
                    "orphan fact kinds, declaration drift, op coverage.")
    ap.add_argument("--ops-from", action="append", default=None,
                    metavar="ARCH",
                    help="trace this arch and report registry op coverage "
                         "against its ops (repeatable; 'all' = the zoo; "
                         "informational, does not gate)")
    ap.add_argument("--tp", type=int, default=4,
                    help="tensor-parallel degree for --ops-from traces")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report ('-' = stdout)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def rulecheck_main(argv: Optional[list] = None) -> int:
    from repro_torch.analysis import check_registry, trace_ops

    args = build_rulecheck_parser().parse_args(argv)
    archs = args.ops_from or []
    if "all" in archs:
        archs = [a for a in archs if a != "all"] + list(ARCH_IDS)
    archs = list(dict.fromkeys(archs))
    known = set(ARCH_IDS) | set(EXTRA_IDS)
    for a in archs:
        if a not in known:
            print(f"error: unknown arch {a!r} "
                  f"(known: {', '.join(sorted(known))})", file=sys.stderr)
            return EXIT_USAGE
    try:
        traced = trace_ops(archs, tp=args.tp) if archs else None
    except (PlanError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_USAGE
    report = check_registry(traced_ops=traced)

    summary_stream = sys.stdout
    if args.json == "-":
        print(report.to_json(indent=2))
        summary_stream = sys.stderr
    elif args.json:
        with open(args.json, "w") as fh:
            fh.write(report.to_json(indent=2) + "\n")
    if not args.quiet:
        print(report.summary(), file=summary_stream)
    return EXIT_VERIFIED if report.ok else EXIT_UNVERIFIED


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "campaign":
        return campaign_main(argv[1:])
    if argv and argv[0] == "lint":
        return lint_main(argv[1:])
    if argv and argv[0] == "rulecheck":
        return rulecheck_main(argv[1:])
    args = build_parser().parse_args(argv)
    if args.list:
        _print_list()
        return EXIT_VERIFIED
    if args.list_injectors:
        _print_injectors()
        return EXIT_VERIFIED
    known = set(ARCH_IDS) | set(EXTRA_IDS)
    if args.arch is None:
        print("error: missing arch (try --list for scenarios and archs)",
              file=sys.stderr)
        return EXIT_USAGE
    if args.arch not in known:
        print(f"error: unknown arch {args.arch!r} "
              f"(known: {', '.join(sorted(known))})", file=sys.stderr)
        return EXIT_USAGE
    from repro_torch.core.inject import InjectorError

    try:
        plan = _plan_of(args)
        mutate = _injector_of(args.inject) if args.inject else None
    except (PlanError, InjectorError) as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_USAGE

    from repro_torch.core.verifier import VerifyOptions

    options = VerifyOptions(engine=args.engine,
                            parallel_workers=args.workers,
                            parallel_backend=args.backend,
                            profile=args.profile,
                            stamp=not args.no_stamp,
                            fusion=not args.no_fusion)
    try:
        with Session(options=options,
                     cache_dir=_cache_dir_of(args)) as session:
            report = session.verify(args.arch, plan, mutate_dist=mutate,
                                    lint=args.lint)
    except PlanError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_USAGE
    except ValueError as e:
        # tracing rejected the plan (e.g. a dim not divisible by tp/dp):
        # the declared plan cannot run on this config — a usage error
        print(f"error: plan {plan.describe()} invalid for {args.arch}: {e}",
              file=sys.stderr)
        return EXIT_USAGE

    summary_stream = sys.stdout
    if args.json == "-":
        print(report.to_json(indent=2))
        summary_stream = sys.stderr  # keep stdout pure JSON
    elif args.json:
        with open(args.json, "w") as fh:
            fh.write(report.to_json(indent=2) + "\n")
    if not args.quiet:
        print(report.summary(), file=summary_stream)
        if args.profile and report.timings.profile:
            print(_profile_lines(report.timings.profile), file=summary_stream)
    return EXIT_VERIFIED if report.verified else EXIT_UNVERIFIED


def _profile_lines(profile: dict, top: int = 10) -> str:
    lines = ["profile (top rules by cumulative time):"]
    for name, row in list(profile.get("rules", {}).items())[:top]:
        lines.append(f"  {name:<28} {row['time_s']*1e3:9.2f} ms"
                     f"  x{row['count']}")
    fams = profile.get("op_families", {})
    if fams:
        lines.append("profile (op families):")
        for name, row in list(fams.items())[:top]:
            lines.append(f"  {name:<28} {row['time_s']*1e3:9.2f} ms"
                         f"  x{row['count']}")
    return "\n".join(lines)
