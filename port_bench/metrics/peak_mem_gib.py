"""The allocator's peak over the window (``torch.cuda.max_memory_allocated``
after a reset at the end of set-up), in GiB."""


def read(f):
    return f["peak_bytes"] / 2**30 if f.get("peak_bytes") else None
