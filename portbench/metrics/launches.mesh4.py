"""launches.mesh4: kernel launches (``cudaLaunchKernel`` and kin) per mesh step
in the profiled stretch, every card's and every thread's."""


def read(run):
    p = run.profile
    return p["launches"] / p["calls"] if p is not None else None
