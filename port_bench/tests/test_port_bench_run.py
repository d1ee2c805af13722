"""``run.py`` as a benchmark check calls it, here without a card, and a whole run
driven on the CPU (the look for a card skipped) with the timed path broken
underneath, which the comparison has to catch."""
import contextlib
import json
import subprocess
import sys
import time

import pytest
import torch

import run
import spec
from tiny import tiny_cell

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_no_card_no_result(workload):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", workload,
                          "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_program_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the harness has no program
    to run: the command fails and prints no result."""
    import shutil

    shutil.copytree(spec.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@contextlib.contextmanager
def broken_forward(kind: str):
    """The program's ``Model.forward`` broken underneath the harness:
    ``half_batch`` computes the first half of the batch and gives its rows,
    their mean, to the rest; ``answer`` alters one request's answer where it
    is produced (the first row's logits shifted by one token); ``token``
    alters one token of it (one position's logits lifted onto another
    token)."""
    from repro_torch.models import model as model_mod

    fwd = model_mod.Model.forward

    def half_batch(self, params, batch, **kw):
        toks = batch["tokens"]
        if toks.shape[0] == 1:  # a batch of one: its second half of positions
            out = fwd(self, params, {"tokens": toks[:, : toks.shape[1] // 2]}, **kw)
            return torch.cat([out, out.mean(1, keepdim=True).expand_as(out)], dim=1)
        h = toks.shape[0] // 2
        out = fwd(self, params, {"tokens": toks[:h]}, **kw)
        rest = out.mean(0, keepdim=True).expand(toks.shape[0] - h, *out.shape[1:])
        return torch.cat([out, rest])

    def token(self, params, batch, **kw):
        out = fwd(self, params, batch, **kw).clone()
        pos = out.shape[1] // 3
        wrong = (out[0, pos].argmax() + 1) % self.cfg.vocab
        out[0, pos, wrong] = out[0, pos].max() + 1.0
        return out

    def answer(self, params, batch, **kw):
        out = fwd(self, params, batch, **kw).clone()
        out[0] = out[0].roll(1, dims=-1)
        return out

    model_mod.Model.forward = {"half_batch": half_batch, "answer": answer, "token": token}[kind]
    try:
        yield
    finally:
        model_mod.Model.forward = fwd


# a single altered token is caught where the widest gap is compared
CASES = [(w, f) for w in CELLS
         for f in [None, "half_batch", "answer"]
         + (["token"] if "gap_max" in spec.load_cell(w).limits else [])]


@pytest.mark.parametrize("workload, fault", CASES)
def test_broken_path_is_not_correct(workload, fault):
    cell = tiny_cell(workload)
    with broken_forward(fault) if fault else contextlib.nullcontext():
        out = run.run_cell(cell, 2**31 + 11, 0.3, False, "cpu", time.perf_counter())
    json.dumps(out)
    assert list(out)[-1] == "checks"
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_both_segments(workload, monkeypatch):
    """A traced run on the CPU, where no device activity exists: the
    profiler and its two reductions are stood in for, and the per-layer metrics are read
    from the untraced window and the two traced segments."""
    import tracing

    monkeypatch.setattr(tracing, "profiler", lambda host_ops=True: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "busy", lambda prof: {"busy_s": 3.0, "window_s": 4.0})
    monkeypatch.setattr(tracing, "reduce", lambda prof, unit, ranges: {
        "busy_s": 1.0, "window_s": 2.0, "device_ops": [["k", 1.0]],
        "idle_gaps": [["forward (1 gaps)", 1.0]], "range_device_s": {"flash_attention": 1.0},
        "reduce_s": 0.0})
    cell = tiny_cell(workload)
    out = run.run_cell(cell, 2**31 + 13, 0.3, True, "cpu", time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["device_idle_pct.prefill"]["value"] < 100.0
    assert out["device"]["busy_s"] == 3.0 and out["device"]["window_s"] == 4.0
    assert {"prefill_mfu", "prefill_tail_mfu", "flash_attention_roofline",
            "peak_mem_pct"} - set(out["metrics"]) == {"peak_mem_pct"}  # no card memory
    assert ("moe_dropped_pct" in out["metrics"]) is ("granite" in workload)
    assert set(out["tokens_per_s_by_segment"]) == {"window", "card_traced",
                                                   "host_and_card_traced"}


@pytest.mark.parametrize("workload", CELLS)
def test_window_runs_whole_passes(workload):
    """Every pass sends the traffic's multiset of lengths once, and a window
    ends on a pass's end, so every seed does the same work."""
    import prefill

    cell = tiny_cell(workload)
    t = cell.traffic
    multiset = sorted(length for length, n in t["lengths"] for _ in range(n))
    for seed in (2**31 + 17, 2**31 + 18):
        passes = prefill.schedule(t, seed)
        for _ in range(3):
            units = next(passes)
            assert sorted(u[1] for u in units) == multiset
            assert all(u[0] == t["batch"] and 0 <= u[2] <= prefill.POOL - u[0] * u[1]
                       for u in units)
        facts, _ = prefill.run(cell, seed, 0.3, False, "cpu", time.perf_counter())
        assert facts["units"] % len(multiset) == 0 and facts["units"] > 0
        assert facts["tokens"] == facts["units"] // len(multiset) * t["batch"] * sum(multiset)
