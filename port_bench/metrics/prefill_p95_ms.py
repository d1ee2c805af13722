"""The 95th percentile (nearest rank) of the time to first token over all
requests of the window: from the call into ``Model.forward`` to the answer
on the host; every prompt of a batch takes its batch's time."""
import yardstick


def read(f):
    if f["kind"] != "prefill":
        return None
    return 1e3 * yardstick.percentile(f["latencies_s"], 95)
