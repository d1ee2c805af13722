"""Device milliseconds a forward of the Mamba-2 mixers: the work launched
inside the program's ``ssm.proj``, ``ssm.conv``, ``ssm.scan``, ``ssm.norm``
and ``ssm.out`` spans (``models/ssm.py`` ``ssm_fwd``), summed over the hybrid
driver's spans segment, over that segment's forwards."""


def read(f):
    if not f.get("ssm_device_s") or not f.get("ssm_forwards"):
        return None
    return 1e3 * sum(f["ssm_device_s"].values()) / f["ssm_forwards"]
