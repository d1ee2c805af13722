"""The share of the untraced prefill window in which nothing ran on the
card: one less the card's busy seconds per prompt token, read in the
segment traced on the card alone, times the window's prompt tokens per
second.  Tracing even the card alone slows the host (chatglm3_6b's
segment ran 5-10% under the window's pace), so the segment's own idle
share is the host's under the tracer, not the program's."""


def read(f):
    if f["kind"] != "prefill" or "busy" not in f:
        return None
    b = f["busy"]
    return 100.0 * (1.0 - b["busy_s"] / b["tokens"] * f["tokens"] / f["elapsed_s"])
