"""Model FLOPs of every unit the window finished (``yardstick.prefill_flops``)
over the window's wall time, as a share of the card's bf16 peak."""
import yardstick


def read(f):
    if f["kind"] != "prefill":
        return None
    return 100.0 * f["model_flops"] / f["elapsed_s"] / yardstick.PEAK_FLOPS_BF16
