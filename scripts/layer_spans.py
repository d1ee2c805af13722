#!/usr/bin/env python3
"""Where a prefill cell's time goes by the program's layers, on the card.

One cell of the benchmark (``BENCHMARK.json``, ``port_bench/``) is set up
and warmed up as ``port_bench/run.py`` sets it up, then runs, in whole
passes of its traffic:

1. ``window``: ``--seconds`` untraced (the pace);
2. ``spans_untraced``: half as long with the program's spans on
   (``scope.spans()``) and no profiler (what the spans cost alone);
3. ``host_and_card_traced``: half as long under ``port_bench/tracing.py``'s
   profiler of every host op, with its ``flash_attention`` range around
   ``kernels.ops.flash_attention`` (the benchmark's own segment);
4. ``program_spans``: half as long with the spans on, under a kineto
   profiler of the CPU and CUDA activities whose host recording is cut to
   user-scope ranges (:func:`user_scope_profiler`): the spans, the CUDA
   runtime's launch calls and the kernels, on one clock.

Segment 4 is reduced (:func:`reduce_spans`) to each span's calls, host
seconds, self device seconds (the kernels whose launch call lies in it and
in none of its children, matched by correlation id) and the idle seconds of
the gaps that began while it was the innermost span; and to three readings:
``moe_dispatch_ms`` (self device ms of ``moe.positions``, ``moe.gather`` and
``moe.combine`` per forward), ``ssm_mixer_ms`` (self device ms of the
``ssm.*`` spans per forward, the Mamba-2 mixers), ``forward_idle_pct`` (idle seconds of the gaps
that began inside ``model.forward``, over the segment's window) and
``launches_per_forward``.  A program without ``scope.spans`` (``--src`` of an
older tree) runs segment 4 without spans, and the readings are null.

    python3 scripts/layer_spans.py --workload granite_moe_3b.prefill_batch16 \\
        --seed 2147500001 --seconds 20 [--src OTHER/src] [--out FILE.json]

Prints one JSON line (also written to ``--out``).  Needs one GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORWARD = "model.forward"
DISPATCH = ("moe.positions", "moe.gather", "moe.combine")
SSM = ("ssm.proj", "ssm.conv", "ssm.scan", "ssm.norm", "ssm.out")
# the benchmark's own definitions of a launch call and of busy time
_spec = importlib.util.spec_from_file_location("port_bench_tracing",
                                               ROOT / "port_bench" / "tracing.py")
bench_tracing = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_tracing)


@contextlib.contextmanager
def user_scope_profiler(cuda: bool = True):
    """A kineto profiler of the CPU (and with ``cuda`` the CUDA) activities
    whose host recording is cut to user-scope ranges (``record_function``):
    no op of the host is recorded, the CUDA runtime's calls and the kernels
    are.  Yields a dict that holds the trace's ``events`` once the block
    has ended.  The public ``torch.profiler.profile`` has no such option."""
    import torch
    from torch._C._profiler import ProfilerActivity, RecordScope, _ExperimentalConfig
    from torch.autograd import profiler as P

    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    config = P.ProfilerConfig(P.ProfilerState.KINETO, False, False, False, False, False,
                              _ExperimentalConfig())
    got = {}
    P._prepare_profiler(config, acts)
    P._enable_profiler(config, acts, {RecordScope.USER_SCOPE})
    try:
        yield got
    finally:
        if cuda:
            torch.cuda.synchronize()
        got["events"] = P._disable_profiler().events()


def events_of(events, span_names) -> list:
    """A kineto trace's events as (kind, name, start_ns, end_ns, correlation)
    tuples: ``span`` (a host range named in ``span_names``), ``launch`` (a
    launch call) or ``device`` (work on the card; a range's device-side echo
    is not)."""
    from torch.autograd import DeviceType

    out = []
    for e in events:
        name, s = e.name(), e.start_ns()
        row = (name, s, s + e.duration_ns(), e.correlation_id())
        if e.device_type() == DeviceType.CPU:
            if name in span_names:
                out.append(("span", *row))
            elif bench_tracing._launch_call(name):
                out.append(("launch", *row))
        elif name not in span_names:
            out.append(("device", *row))
    return out


def reduce_spans(events: list, unit: str = "request", program: tuple = ()) -> dict:
    """Readings of ``events`` (:func:`events_of`) from the first ``unit``
    span's start to the last one's end.  ``program``: the program's span
    names (``scope.SPANS``); every other span is the caller's own.

    ``program_spans[name]``: calls, host seconds, self launch calls and self
    device seconds, idle seconds (of the gaps that began while it was the
    innermost open span), and its three largest kernels by self device
    seconds.
    ``outside_device_s``: device seconds launched outside any program span;
    ``unmatched_device_s``: of work whose launch call the trace lacks.
    ``idle_gaps``: idle seconds by the innermost span, the program's or the
    caller's, the host was in when each gap began."""
    spans = [(s, e, n) for k, n, s, e, _ in events if k == "span"]
    units = [(s, e) for s, e, n in spans if n == unit]
    if not units:
        raise RuntimeError(f"the trace holds no {unit!r} span")
    t0, t1 = min(s for s, _ in units), max(e for _, e in units)
    spans = sorted(((s, e, n) for s, e, n in spans if t0 <= s <= t1),
                   key=lambda x: (x[0], -x[1]))
    device = [(max(s, t0), min(e, t1), n, c) for k, n, s, e, c in events
              if k == "device" and min(e, t1) > max(s, t0)]
    busy_ns, merged = bench_tracing._union([(s, e) for s, e, _, _ in device])
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    # the sweep: span starts (0), launch calls and gap starts (1), span ends (2)
    sweep = [(s, 0, i) for i, (s, _, _) in enumerate(spans)]
    sweep += [(e, 2, i) for i, (_, e, _) in enumerate(spans)]
    sweep += [(s, 1, ("launch", c)) for k, _, s, _, c in events
              if k == "launch" and t0 <= s <= t1]
    sweep += [(gs, 1, ("gap", ge - gs)) for gs, ge in zip(edges[0::2], edges[1::2]) if ge > gs]
    sweep.sort(key=lambda x: (x[0], x[1]))
    prog = set(program)
    stack, owner, launched = [], {}, set()
    self_launches = defaultdict(int)
    gaps = defaultdict(lambda: [0, 0.0])
    idle = defaultdict(float)
    in_forward = {"launches": 0, "idle_s": 0.0}
    for _, kind, what in sweep:
        if kind == 0:
            stack.append(what)
        elif kind == 2:
            if what in stack:
                del stack[len(stack) - 1 - stack[::-1].index(what)]
        else:
            names = [spans[i][2] for i in stack]
            forward = FORWARD in names
            if what[0] == "launch":
                launched.add(what[1])
                mine = [n for n in names if n in prog]
                if mine:
                    owner[what[1]] = mine[-1]
                    self_launches[mine[-1]] += 1
                in_forward["launches"] += forward
            else:
                top = names[-1] if names else "no span"
                gaps[top][0] += 1
                gaps[top][1] += what[1] * 1e-9
                if top in prog:
                    idle[top] += what[1] * 1e-9
                if forward:
                    in_forward["idle_s"] += what[1] * 1e-9
    self_s, ops = defaultdict(float), defaultdict(lambda: defaultdict(float))
    outside = unmatched = 0.0
    for s, e, name, c in device:
        d = (e - s) * 1e-9
        if c in owner:
            self_s[owner[c]] += d
            ops[owner[c]][name] += d
        elif c in launched:
            outside += d
        else:
            unmatched += d
    table = {}
    for s, e, n in spans:
        if n in prog:
            row = table.setdefault(n, {"calls": 0, "host_s": 0.0})
            row["calls"] += 1
            row["host_s"] += (e - s) * 1e-9
    for n, row in table.items():
        row.update(launches=self_launches[n], self_device_s=self_s[n], idle_s=idle[n],
                   top_ops=[[k[:120], v] for k, v in
                            sorted(ops[n].items(), key=lambda kv: -kv[1])[:3]])
    window_s = (t1 - t0) * 1e-9
    forwards = table.get(FORWARD, {}).get("calls", 0)
    dispatch = [table[n]["self_device_s"] for n in DISPATCH if n in table]
    ssm = [table[n]["self_device_s"] for n in SSM if n in table]
    readings = {
        "moe_dispatch_ms": 1e3 * sum(dispatch) / forwards if forwards and dispatch else None,
        "ssm_mixer_ms": 1e3 * sum(ssm) / forwards if forwards and ssm else None,
        "forward_idle_pct": 100.0 * in_forward["idle_s"] / window_s if forwards else None,
        "launches_per_forward": in_forward["launches"] / forwards if forwards else None,
    }
    top = sorted(((f"{k} ({n} gaps)", v) for k, (n, v) in gaps.items()), key=lambda kv: -kv[1])
    return {"window_s": window_s, "busy_s": busy_ns * 1e-9,
            "device_s": sum(e - s for s, e, _, _ in device) * 1e-9,
            "program_spans": table, "outside_device_s": outside,
            "unmatched_device_s": unmatched, "idle_gaps": [[k, v] for k, v in top[:16]],
            "readings": readings}


# --------------------------------------------------------------------- on the card
def run(workload: str, seed: int, seconds: float) -> dict:
    import torch

    import card
    import prefill
    import spec
    from repro_torch import scope
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ops as kops

    cell = spec.load_cell(workload)
    if cell.traffic["kind"] not in ("prefill", "prefill_hybrid"):
        raise SystemExit(f"{workload}: not a prefill cell")
    traffic, vocab = cell.traffic, cell.config["port"]["vocab"]
    kbuild.build_all()
    model, params, pool = prefill.build(cell.config, "cuda", seed)
    passes = prefill.schedule(traffic, seed)
    has_spans = hasattr(scope, "spans")
    on = scope.spans if has_spans else contextlib.nullcontext
    program = scope.SPANS if has_spans else ()

    def loop(secs: float) -> list:
        done = []
        deadline = time.perf_counter() + secs
        while time.perf_counter() < deadline:
            for b, length, off in next(passes):
                tokens = pool[off: off + b * length].view(b, length)
                t0 = time.perf_counter()
                with bench_tracing.record_function("request"):
                    prefill.answer(model, params, tokens, vocab)
                done.append((b, length, off, t0, time.perf_counter()))
        return done

    out = {"workload": workload, "seed": seed, "card": card.describe(),
           "torch": torch.__version__, "program_has_spans": has_spans}
    with torch.inference_mode():
        for b, length in sorted({(traffic["batch"], n) for n, _ in traffic["lengths"]}):
            prefill.answer(model, params, pool[: b * length].view(b, length), vocab)
        torch.cuda.synchronize()
        pace = {"window": loop(seconds)}
        with on():
            pace["spans_untraced"] = loop(seconds / 2)
        with bench_tracing.wrap(kops, "flash_attention", "flash_attention"):
            with bench_tracing.profiler() as prof:
                pace["host_and_card_traced"] = loop(seconds / 2)
        full = bench_tracing.reduce(prof, "request", ("flash_attention",))
        del prof
        with on(), user_scope_profiler() as got:
            pace["program_spans"] = loop(seconds / 2)
    names = set(program) | set(bench_tracing.SPANS)
    t = time.perf_counter()
    red = reduce_spans(events_of(got["events"], names), "request", program)
    red["reduce_s"] = time.perf_counter() - t
    out.update(red)
    out["tokens_per_s_by_segment"] = {k: prefill.tokens_per_s(v) for k, v in pace.items()}
    fwd_full = len(pace["host_and_card_traced"])
    fwd_spans = red["program_spans"].get(FORWARD, {}).get("calls", 0)
    out["host_and_card"] = {"forwards": fwd_full, "device_ops": full["device_ops"],
                            "idle_gaps": full["idle_gaps"],
                            "flash_attention_device_s": full["range_device_s"]["flash_attention"]}
    if fwd_spans:
        core = red["program_spans"].get("attn.core", {})
        k1 = sum(v for name, v in core.get("top_ops", ()) if "flash_fwd" in name)
        out["checks"] = {
            "forwards": fwd_spans,
            "attn_core_per_forward_s": core.get("self_device_s", 0.0) / fwd_spans,
            "attn_core_k1_per_forward_s": k1 / fwd_spans,
            "flash_attention_per_forward_s":
                full["range_device_s"]["flash_attention"] / fwd_full,
            "accounted_share": (sum(r["self_device_s"] for r in red["program_spans"].values())
                                + red["outside_device_s"]) / red["device_s"]
            if red["device_s"] else None,
        }
    # one switched-off span's host cost, entered and left
    if has_spans:
        n = 200_000
        t = time.perf_counter()
        for _ in range(n):
            with scope.span("model.forward"):
                pass
        out["span_off_us"] = (time.perf_counter() - t) / n * 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--src", default=str(ROOT / "src"), help="the program's src directory")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "port_bench"), str(Path(args.src).resolve())]
    import torch

    if not torch.cuda.is_available():
        print("layer_spans: no CUDA device available", file=sys.stderr)
        return 2
    line = json.dumps(run(args.workload, args.seed, args.seconds))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
