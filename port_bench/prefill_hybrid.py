"""The prefill driver for a stack of mixed layers (Mamba-2 mixers beside
attention, experts with a shared expert): ``prefill.py``'s closed loop,
set-up, traced segments and reference check, with two differences.

- Model FLOPs are counted by ``yardstick_hybrid.prefill_flops`` (attention
  only in the attention layers, the Mamba-2 projections and SSD scan in the
  others, the shared expert), so ``prefill_mfu`` reads the hybrid count.
- The weights are ``prefill.build``'s with the embedding divided by the
  configuration's ``embedding_multiplier`` (``build``), so that the scaled
  embedding enters the residual stream at unit row norm, as the other
  cells' embeddings do.  Drawn at N(0, 1/D) and scaled by 12, a token's own
  row would dominate its tied logit (about 11 against 4.4 for the best of
  the other 100,351 at granite's widths): every greedy answer would be the
  prompt's own token, which no rounding moves, and the check would read 0
  for the program and the fp8 control alike.
- A traced run adds one more segment of ``seconds / 2``, inside the
  program's own spans (``repro_torch.scope.spans()``), under the profiler
  of host and card, with ``kernels.ops.ssd_scan`` wrapped in the benchmark's
  ``ssd_scan`` range (each call's shapes noted).  It gives the K3 calls'
  least time (``yardstick_hybrid.ssd_scan_bound_s``) and device time, the
  device time launched inside each ``ssm.*`` span, and the segment's
  forwards; a program without those spans leaves them out.
"""
from __future__ import annotations

import time

import torch

import card
import check
import prefill
import tracing
import yardstick_hybrid

SSM_SPANS = ("ssm.proj", "ssm.conv", "ssm.scan", "ssm.norm", "ssm.out")


_PREFILL_BUILD = prefill.build


def build(config: dict, device: str, seed: int):
    """``prefill.build``'s model, weights and prompts, the embedding divided
    by ``embedding_multiplier``."""
    model, params, pool = _PREFILL_BUILD(config, device, seed)
    params["embed"]["w"].div_(config["port"].get("embedding_multiplier", 1.0))
    return model, params, pool


def spans_segment(model, params, pool, traffic: dict, seed: int, seconds: float,
                  vocab: int) -> dict:
    """Whole passes for ``seconds`` with the program's spans on, traced on host
    and card; the readings of the SSM layers."""
    from repro_torch import scope
    from repro_torch.kernels import ops as kops

    calls, done = [], []

    def note_scan(x, dt, A, Bm, Cm, *, chunk: int = 128, **_):
        calls.append(((*x.shape, Bm.shape[-1], chunk), x.dtype == torch.bfloat16))

    passes = prefill.schedule(traffic, seed)
    program = tuple(getattr(scope, "SPANS", ()))
    with torch.inference_mode(), scope.spans():
        with tracing.wrap(kops, "ssd_scan", "ssd_scan", note_scan):
            with tracing.profiler() as prof:
                deadline = time.perf_counter() + seconds
                while time.perf_counter() < deadline:
                    for b, length, off in next(passes):
                        t0 = time.perf_counter()
                        with tracing.record_function("request"):
                            prefill.answer(model, params, pool[off: off + b * length]
                                           .view(b, length), vocab)
                        done.append((b, length, off, t0, time.perf_counter()))
    ranges = ("ssd_scan",) + tuple(s for s in SSM_SPANS if s in program)
    red = tracing.reduce(prof, "request", ranges,
                         spans_named=tracing.SPANS + program + ("ssd_scan",))
    out = {"ssm_forwards": len(done), "ssm_tokens_per_s": prefill.tokens_per_s(done),
           "ssd_scan_calls": len(calls),
           "ssd_scan_bound_s": sum(yardstick_hybrid.ssd_scan_bound_s(*shape, bf16=bf16)
                                   for shape, bf16 in calls),
           "ssd_scan_device_s": red["range_device_s"]["ssd_scan"]}
    if "ssm.scan" in program:
        out["ssm_device_s"] = {s: red["range_device_s"][s] for s in SSM_SPANS}
    return out


def run(cell, seed: int, seconds: float, traced: bool, device: str, t_start: float):
    """One run of a hybrid prefill cell: ``prefill.run`` with the hybrid count
    and, traced, the spans segment.  Returns (facts, compared numbers)."""
    m = cell.config["port"]
    t0 = time.perf_counter()
    model, params, pool = build(cell.config, device, seed)
    t1 = time.perf_counter()
    win = prefill.drive(model, params, pool, cell.traffic, seed, seconds, traced, m["vocab"])
    ssm = (spans_segment(model, params, pool, cell.traffic, seed, seconds / 2, m["vocab"])
           if traced else {})
    out = prefill.facts(win, m, *card.memory(device))
    out["unit_flops"] = [yardstick_hybrid.prefill_flops(m, u[0], u[1]) for u in win.units]
    out["model_flops"] = sum(out["unit_flops"])
    out.update(ssm)
    if traced:  # the spans segment's pace beside the others'
        out["tokens_per_s_by_segment"]["ssm_spans"] = out.pop("ssm_tokens_per_s")
    out["setup_s"] = win.units[0][3] - t_start
    out["setup_phases"] = {"before_weights_s": t0 - t_start, "weights_s": t1 - t0,
                           "warmup_s": win.warmup_s}
    units = prefill.checked_units(win, seed)
    out["checked"] = sum(u[0] for u in units)
    numbers = prefill.reference_check(check.reference_module(cell.config), m, params, pool,
                                      units)["program"]
    return out, numbers


if __name__ == "__main__":
    # the readings behind a hybrid cell's limits: port_bench/control.py with
    # this driver's weights (same arguments)
    import sys

    import control

    prefill.build = build
    sys.exit(control.main())
