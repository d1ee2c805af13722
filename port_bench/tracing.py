"""The traced run's readings, from two ``torch.profiler`` traces.

- ``busy``: a trace of the card's activity alone (no host ops recorded, so
  the host runs nearly as fast as untraced) reduced to the seconds in
  which something ran on the card, over the traced window.
- ``reduce``: a trace of the host's ops and the card's, reduced to device
  time by kernel and by the benchmark's ranges, and the idle gaps labelled
  by the span the host was in.  Recording every host op slows the host, so
  its gaps are longer than an untraced run's.

Spans are ``record_function`` ranges opened by the benchmark (never inside
the program): a cell's unit of work, and a wrapper around a layer's entry
point installed only for the traced run (``wrap``).
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import time
from collections import defaultdict

from torch.profiler import ProfilerActivity, profile, record_function

# every span the benchmark opens, on the host (a device trace echoes them)
SPANS = ("request", "forward", "answer", "flash_attention")


@contextlib.contextmanager
def wrap(module, attr: str, span: str, on_call=None):
    """Replace ``module.attr`` by a wrapper that runs it inside a
    ``record_function(span)`` range (and calls ``on_call(*args, **kw)``
    first), for the duration of the block."""
    fn = getattr(module, attr)

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        if on_call is not None:
            on_call(*args, **kw)
        with record_function(span):
            return fn(*args, **kw)

    setattr(module, attr, wrapped)
    try:
        yield
    finally:
        setattr(module, attr, fn)


def profiler(host_ops: bool = True):
    """A profiler of the card's activity, and with ``host_ops`` of every
    op the host runs."""
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    return profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)


def _union(intervals: list) -> tuple[float, list]:
    """Total length of the union of (start, end) intervals and the merged
    intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _launch_call(name: str) -> bool:
    """A CUDA runtime or driver call that puts work on the device."""
    return name.startswith("cu") and any(w in name for w in ("Launch", "Memcpy", "Memset"))


def busy(prof) -> dict:
    """``busy_s``, the union of the card's activity in a trace of the card
    alone, and ``window_s``, from its first activity's start to its last
    one's end."""
    from torch.autograd import DeviceType

    device = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() != DeviceType.CPU and e.name() not in SPANS]
    if not device:
        raise RuntimeError("the trace holds no device activity")
    busy_ns, _ = _union(device)
    return {"busy_s": busy_ns * 1e-9,
            "window_s": (max(t for _, t in device) - min(s for s, _ in device)) * 1e-9}


def reduce(prof, unit: str, ranges: tuple = (), spans_named: tuple = SPANS) -> dict:
    """Readings of the profiled window, from the first ``unit`` span's start
    to the last one's end: ``busy_s`` (the union of device activity in it),
    ``window_s``, ``device_ops`` (the ten largest device seconds by name),
    ``range_device_s`` (seconds of the device activity launched inside each
    of ``ranges``' spans), and ``idle_gaps`` (idle seconds between device
    activity, summed by the innermost benchmark span the host was in when
    each gap began).  ``spans_named``: the benchmark's span names (their
    device-side echoes are not device work)."""
    from torch.autograd import DeviceType

    t_start = time.perf_counter()
    spans, device, launches = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name in spans_named:
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                              e.correlation_id()))
            elif _launch_call(name):
                launches.append((e.start_ns(), e.correlation_id()))
        elif name not in spans_named:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                           e.correlation_id()))
    units = [(s, t) for s, t, name, _ in spans if name == unit]
    if not units:
        raise RuntimeError(f"the trace holds no {unit!r} span")
    t0, t1 = min(s for s, _ in units), max(t for _, t in units)
    device = [(max(s, t0), min(t, t1), n, c) for s, t, n, c in device if min(t, t1) > max(s, t0)]
    busy_ns, merged = _union([(s, t) for s, t, _, _ in device])
    by_name = defaultdict(float)
    for s, t, name, _ in device:
        by_name[name] += (t - s) * 1e-9
    launches.sort()
    starts = [s for s, _ in launches]
    range_s = {}
    for name in ranges:  # device work whose launch call lies inside the range
        ids = set()
        for s, t, n, _ in spans:
            if n == name:
                lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, t)
                ids.update(c for _, c in launches[lo:hi])
        range_s[name] = sum((t - s) * 1e-9 for s, t, _, c in device if c in ids)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    sweep = [(s, 0, name) for s, _, name, _ in spans] + [(t, 2, name) for _, t, name, _ in spans]
    sweep += [(gs, 1, ge - gs) for gs, ge in zip(edges[0::2], edges[1::2]) if ge > gs]
    sweep.sort(key=lambda x: (x[0], x[1]))
    stack, gaps = [], defaultdict(lambda: [0, 0.0])
    for _, kind, what in sweep:
        if kind == 0:
            stack.append(what)
        elif kind == 2:
            if what in stack:
                del stack[len(stack) - 1 - stack[::-1].index(what)]
        else:
            g = gaps[stack[-1] if stack else "no span"]
            g[0] += 1
            g[1] += what * 1e-9
    top = [(k[:160], v) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    idle = sorted(((f"{k} ({n} gaps)", v) for k, (n, v) in gaps.items()),
                  key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_ns * 1e-9, "window_s": (t1 - t0) * 1e-9,
            "device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle],
            "range_device_s": range_s, "reduce_s": time.perf_counter() - t_start}
