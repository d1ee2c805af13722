"""The units at or above the 95th percentile latency: their model FLOPs
over their summed latency, as a share of the card's bf16 peak."""
import yardstick


def read(f):
    if f["kind"] != "prefill":
        return None
    p95 = yardstick.percentile(f["latencies_s"], 95)
    tail = [(fl, t) for fl, t in zip(f["unit_flops"], f["unit_latencies_s"]) if t >= p95]
    return 100.0 * sum(fl for fl, _ in tail) / sum(t for _, t in tail) / yardstick.PEAK_FLOPS_BF16
