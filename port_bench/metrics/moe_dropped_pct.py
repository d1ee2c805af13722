"""(token, slot) pairs that the capacity dispatch dropped, over all pairs
routed in the traced window (``mlp.record_routing``'s counts)."""


def read(f):
    if not f.get("moe_pairs"):
        return None
    return 100.0 * f["moe_dropped"] / f["moe_pairs"]
