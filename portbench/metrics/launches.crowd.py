"""launches.crowd: kernel launches (``cudaLaunchKernel`` and kin) per call in the
profiled stretch."""


def read(run):
    p = run.profile
    return p["launches"] / p["calls"] if p is not None else None
