"""device_idle.viewer: the share of the profiled stretch's wall time in which no
operation ran on the device, in percent."""


def read(run):
    p = run.profile
    return (1.0 - p["busy_s"] / p["wall_s"]) * 100.0 if p is not None and p["wall_s"] > 0 else None
