"""The attention calls' least time on the card (``yardstick.attention_bound_s``
of each call's shapes) over the device time of the work launched inside the
benchmark's ``flash_attention`` range around ``kernels.ops.flash_attention``."""


def read(f):
    if not f.get("attention_device_s"):
        return None
    return 100.0 * f["attention_bound_s"] / f["attention_device_s"]
