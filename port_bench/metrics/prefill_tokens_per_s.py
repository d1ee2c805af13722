"""Prompt tokens of every unit the window finished, over the time from the
window's start to the last unit's end."""


def read(f):
    if f["kind"] != "prefill":
        return None
    return f["tokens"] / f["elapsed_s"]
