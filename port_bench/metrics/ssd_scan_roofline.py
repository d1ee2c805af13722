"""The SSD scan calls' least time on the card (``yardstick_hybrid.ssd_scan_bound_s``
of each call's shapes) over the device time of the work launched inside the
benchmark's ``ssd_scan`` range around ``kernels.ops.ssd_scan`` (K3), in the
hybrid driver's spans segment."""


def read(f):
    if not f.get("ssd_scan_device_s"):
        return None
    return 100.0 * f["ssd_scan_bound_s"] / f["ssd_scan_device_s"]
