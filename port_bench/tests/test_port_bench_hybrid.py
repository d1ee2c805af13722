"""The hybrid cell (``prefill_hybrid.py``, ``reference/hybrid.py``,
``yardstick_hybrid.py``) on the CPU at a small size: a whole run is correct,
a broken timed path is not, the fp8 control fails the limits, and a traced
run (the profiler stood in for) reads the SSM metrics and the hybrid FLOP
count."""
import contextlib
import copy
import time

import pytest

import control
import run
import spec
import yardstick_hybrid
from test_port_bench_run import broken_forward

CELL = "granite_4_0_h_small.prefill_8x4096"


def tiny_hybrid():
    """The cell at a few dozen channels: its pattern at a period of 4
    (attention at layer 2), 6 experts top-3 with a shared expert, the gated
    norm over the whole inner width, and a chunk of 16 so that prompts of 32
    and 64 tokens carry the scan's state across chunks."""
    cell = spec.load_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["port"].update(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                       vocab=256, n_experts=6, top_k=3, d_ff_expert=32, shared_expert_ff=48,
                       attn_period=4, attn_offset=2, ssm_state=16, ssm_head_dim=16,
                       ssm_norm_group=128, ssm_chunk=16, attention_multiplier=1 / 16)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, lengths=[[32, 2], [64, 1]], batch=4)
    # over eight seeds (the driver's weights) the CPU read the program's
    # gap_mean at 9e-06 to 3.0e-05 and flip_pct at 3.6-6.8, the control's at
    # 4.0e-04 to 5.9e-04 and 30-35
    cell.limits = {"gap_mean": 1.1e-4, "flip_pct": 14.0}
    return cell


def _fails(numbers, limits):
    return any(numbers[k] > lim for k, lim in limits.items())


@pytest.mark.parametrize("fault", [None, "half_batch", "answer"])
def test_hybrid_run_correct_and_broken_path_not(fault):
    cell = tiny_hybrid()
    with broken_forward(fault) if fault else contextlib.nullcontext():
        out = run.run_cell(cell, 2**31 + 11, 0.3, False, "cpu", time.perf_counter())
    assert out["correct"] is (fault is None), out["checks"]
    assert set(out["metrics"]) == {"prefill_tokens_per_s", "prefill_p95_ms", "setup_s"}


@pytest.mark.parametrize("seed", [2**31 + 3, 2**31 + 5])
def test_hybrid_control_fails(seed, monkeypatch):
    import prefill
    import prefill_hybrid

    monkeypatch.setattr(prefill, "build", prefill_hybrid.build)  # as its __main__ does
    cell = tiny_hybrid()
    row = control.readings(cell, seed, 0.3, True, "cpu")
    assert not _fails(row["program"], cell.limits), row
    assert _fails(row["control"], cell.limits), row


def test_hybrid_traced_run_reads_the_ssm_metrics(monkeypatch):
    """The profiler and its reductions stood in for, as in
    ``test_port_bench_run`` (each range read as 1 s of device time); the
    spans segment's K3 calls are counted."""
    import prefill_hybrid
    import tracing

    calls = []
    monkeypatch.setattr(tracing, "profiler", lambda host_ops=True: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "busy", lambda prof: {"busy_s": 3.0, "window_s": 4.0})

    def reduce(prof, unit, ranges, spans_named=tracing.SPANS):
        calls.append((ranges, spans_named))
        return {"busy_s": 1.0, "window_s": 2.0, "device_ops": [["k", 1.0]],
                "idle_gaps": [["forward (1 gaps)", 1.0]],
                "range_device_s": {r: 1.0 for r in ranges}, "reduce_s": 0.0}

    monkeypatch.setattr(tracing, "reduce", reduce)
    cell = tiny_hybrid()
    out = run.run_cell(cell, 2**31 + 13, 0.3, True, "cpu", time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert {"prefill_mfu", "prefill_tail_mfu", "flash_attention_roofline", "moe_dropped_pct",
            "ssd_scan_roofline", "ssm_mixer_ms", "device_idle_pct.prefill"} <= set(out["metrics"])
    assert set(out["tokens_per_s_by_segment"]) == {"window", "card_traced",
                                                   "host_and_card_traced", "ssm_spans"}
    ranges, named = calls[-1]
    assert ranges == ("ssd_scan", "ssm.proj", "ssm.conv", "ssm.scan", "ssm.norm", "ssm.out")
    assert {"request", "ssd_scan", "ssm.scan", "model.forward", "moe.gather"} <= set(named)
    facts, _ = prefill_hybrid.run(cell, 2**31 + 13, 0.3, True, "cpu", time.perf_counter())
    # three Mamba-2 layers a forward, one K3 call each
    assert facts["ssd_scan_calls"] == 3 * facts["ssm_forwards"] > 0
    assert spec.reader("ssm_mixer_ms")(facts) == pytest.approx(5e3 / facts["ssm_forwards"])
    # the model FLOPs are the hybrid count of each unit
    counts = {yardstick_hybrid.prefill_flops(cell.config["port"], 4, n) for n in (32, 64)}
    assert set(facts["unit_flops"]) == counts
    assert facts["model_flops"] == sum(facts["unit_flops"])


def test_ssm_metrics_read_null_without_their_facts():
    facts = {"kind": "prefill", "peak_bytes": 0}
    for name in ("ssd_scan_roofline", "ssm_mixer_ms"):
        assert spec.reader(name)(facts) is None
    assert spec.reader("ssm_mixer_ms")({"ssm_device_s": {"ssm.scan": 1.0},
                                        "ssm_forwards": 4}) == pytest.approx(250.0)
    assert spec.reader("ssd_scan_roofline")({"ssd_scan_bound_s": 1.0,
                                             "ssd_scan_device_s": 4.0}) == 25.0
