"""The prefill driver: one client sends prompts through the program's
``Model.forward`` (``impl="kernel"``, ``moe_impl="capacity"``) in a closed
loop, each answer read back to the host before the next is sent.

A unit of work is one forward of ``batch`` prompts of one length; its
answer is the greedy next token at every position (the argmax of the
logits over the published vocabulary), copied to the host.  The lengths
come from the traffic file, each pass sending every length of its multiset
once in an order drawn from the seed; the prompts are slices of one pool
of token ids drawn on the card, at offsets drawn from the seed.
"""
from __future__ import annotations

import random
import time

import torch

import card
import check
import inputs
import tracing
import yardstick

POOL = 1 << 21  # token ids drawn once; every prompt is a slice of them


def schedule(traffic: dict, seed: int):
    """Passes, in sending order: each pass is the (batch, length, offset) of
    every unit of the traffic's multiset of lengths once, in an order and
    at offsets drawn from the seed."""
    rng = random.Random(seed)
    units = [length for length, n in traffic["lengths"] for _ in range(n)]
    while True:
        order = units[:]
        rng.shuffle(order)
        yield [(traffic["batch"], length, rng.randrange(POOL - traffic["batch"] * length + 1))
               for length in order]


def build(config: dict, device: str, seed: int):
    """The program's model and the benchmark's weights for ``config``."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import Model

    cfg = ArchConfig(name=config["name"], **config["port"])
    model = Model(cfg, impl="kernel", moe_impl="capacity", device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = inputs.draw_weights(model, gen)
    pool = inputs.token_pool(gen, cfg.vocab, POOL)
    return model, params, pool


def answer(model, params, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """One unit of work: the forward, then its greedy token at every
    position, on the host."""
    with tracing.record_function("forward"):
        logits = model.forward(params, {"tokens": tokens})
    with tracing.record_function("answer"):
        return logits[..., :vocab].argmax(-1).cpu()


class Window:
    """What the measured window did: each unit's (batch, length, offset,
    start, end, answer); in a traced run also the busy share of a segment
    traced on the card alone (``busy``), from a segment traced on host and
    card (``trace``) the attention calls' shapes and the MoE pairs routed
    and dropped, and the pace of the window and of each segment."""

    def __init__(self):
        self.units = []
        self.attention = []
        self.pairs = 0
        self.dropped = None
        self.warmup_s = 0.0
        self.card_before = self.card_after = None
        self.busy = None
        self.trace = None
        self.tokens_per_s = None


def drive(model, params, pool, traffic: dict, seed: int, seconds: float,
          traced: bool, vocab: int) -> Window:
    """Warm up each unit shape once, then run whole passes until ``seconds``
    have passed: the pass running at the deadline is finished and counted,
    so every run does the same work, a whole number of passes.  A
    traced run goes on with two traced segments of half as long each: the
    first traced on the card alone, the second on host and card."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import mlp

    shapes = {(traffic["batch"], length) for length, _ in traffic["lengths"]}
    t0 = time.perf_counter()
    with torch.inference_mode():
        for b, length in sorted(shapes):
            answer(model, params, pool[: b * length].view(b, length), vocab)
    card.reset_peak(str(pool.device))
    win = Window()
    win.warmup_s = time.perf_counter() - t0
    win.card_before = card.state()
    passes = schedule(traffic, seed)
    moe_layers = sum(model.cfg.is_moe_layer(i) for i in range(model.cfg.n_layers))

    def note_attention(q, k, v, **_):
        win.attention.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3]))

    def loop(seconds: float, done: list, routing: bool = False):
        deadline = time.perf_counter() + seconds
        while time.perf_counter() < deadline:
            for b, length, off in next(passes):
                tokens = pool[off: off + b * length].view(b, length)
                t0 = time.perf_counter()
                with tracing.record_function("request"):
                    if routing:
                        with mlp.record_routing() as rec:
                            ids = answer(model, params, tokens, vocab)
                        d = torch.stack([r["dropped"] for r in rec]).sum()
                        win.dropped = d if win.dropped is None else win.dropped + d
                        win.pairs += b * length * model.cfg.top_k * len(rec)
                    else:
                        ids = answer(model, params, tokens, vocab)
                done.append((b, length, off, t0, time.perf_counter(), ids))

    with torch.inference_mode():
        loop(seconds, win.units)
        win.card_after = card.state()
        if traced:
            card_only, host_and_card = [], []
            with tracing.profiler(host_ops=False) as prof:
                loop(seconds / 2, card_only)
            win.busy = dict(tracing.busy(prof), tokens=sum(u[0] * u[1] for u in card_only))
            with tracing.wrap(kops, "flash_attention", "flash_attention", note_attention):
                with tracing.profiler() as prof:
                    loop(seconds / 2, host_and_card, routing=moe_layers > 0)
            win.trace = tracing.reduce(prof, "request", ("flash_attention",))
            # the traced segments' pace beside the window's: what each
            # tracer costs the host
            win.tokens_per_s = {name: tokens_per_s(done) for name, done in
                                (("window", win.units), ("card_traced", card_only),
                                 ("host_and_card_traced", host_and_card))}
    return win


def tokens_per_s(units: list) -> float:
    """Prompt tokens of ``units`` over the time from the first one's start
    to the last one's end."""
    return sum(u[0] * u[1] for u in units) / (units[-1][4] - units[0][3])


def facts(win: Window, m: dict, peak_bytes: int, total_bytes: int) -> dict:
    """The window's readings, which the metric readers take their numbers
    from: the untraced window's units and, in a traced run, the traced
    segments' readings."""
    lat = [u[4] - u[3] for u in win.units]
    flops = [yardstick.prefill_flops(m, u[0], u[1]) for u in win.units]
    out = {"kind": "prefill", "units": len(win.units),
           "requests": sum(u[0] for u in win.units),
           "tokens": sum(u[0] * u[1] for u in win.units),
           "elapsed_s": win.units[-1][4] - win.units[0][3],
           "latencies_s": [t for u, t in zip(win.units, lat) for _ in range(u[0])],
           "model_flops": sum(flops), "unit_latencies_s": lat, "unit_flops": flops,
           "peak_bytes": peak_bytes, "total_bytes": total_bytes,
           "card": {"before": win.card_before, "after": win.card_after}}
    if win.trace is not None:
        out["busy"] = win.busy
        out["trace"] = win.trace
        out["tokens_per_s_by_segment"] = win.tokens_per_s
        out["attention_bound_s"] = sum(yardstick.attention_bound_s(*a) for a in win.attention)
        out["attention_device_s"] = win.trace["range_device_s"]["flash_attention"]
        if win.dropped is not None:
            out["moe_pairs"] = win.pairs
            out["moe_dropped"] = int(win.dropped)
    return out


def checked_units(win: Window, seed: int) -> list:
    """The units the reference checks: one of each length, drawn from the
    seed among those the window finished (so the longest is among them)."""
    rng = random.Random(f"{seed}:check")
    by_len = {}
    for u in win.units:
        by_len.setdefault(u[1], []).append(u)
    return [rng.choice(by_len[length]) for length in sorted(by_len)]


def reference_check(ref, m: dict, params, pool, units: list, control: bool = False) -> dict:
    """The program's answers (and with ``control`` the fp8 reference's)
    against the float32 reference, over every position of ``units``."""
    gaps = {}
    for b, length, off, _, _, ans in units:
        answers = {"program": ans}
        if control:
            answers["control"] = None
        with tracing.record_function("reference check"):
            check.gaps_of(ref, m, params, pool[off: off + b * length].view(b, length),
                          answers, gaps)
    return {name: g.numbers() for name, g in gaps.items()}


def run(cell, seed: int, seconds: float, traced: bool, device: str, t_start: float):
    """One run of a prefill cell: set-up, the window, then the reference
    check once the memory peak is read.  Returns (facts, compared numbers)."""
    m = cell.config["port"]
    t0 = time.perf_counter()
    model, params, pool = build(cell.config, device, seed)
    t1 = time.perf_counter()
    win = drive(model, params, pool, cell.traffic, seed, seconds, traced, m["vocab"])
    out = facts(win, m, *card.memory(device))
    out["setup_s"] = win.units[0][3] - t_start
    out["setup_phases"] = {"before_weights_s": t0 - t_start, "weights_s": t1 - t0,
                           "warmup_s": win.warmup_s}
    units = checked_units(win, seed)
    out["checked"] = sum(u[0] for u in units)
    numbers = reference_check(check.reference_module(cell.config), m, params, pool,
                              units)["program"]
    return out, numbers

