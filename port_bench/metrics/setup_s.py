"""Set-up: from the start of the process to the window's first unit of
work (the kernels' build in a run that builds, the weights and inputs, the
warm-up of each shape)."""


def read(f):
    return f.get("setup_s")
