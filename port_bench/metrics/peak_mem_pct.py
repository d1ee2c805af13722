"""The window's memory peak as a share of the card's memory."""


def read(f):
    if not f.get("peak_bytes") or not f.get("total_bytes"):
        return None
    return 100.0 * f["peak_bytes"] / f["total_bytes"]
