"""shard_ms.mesh4: the slowest shard's host milliseconds in each mesh step
(its ``crowd.step`` less its lane's waits for the host turn and for its
card), averaged over the window's mesh steps. None where the port has no
``crowd.mesh_step``."""


def read(run):
    steps = (getattr(run, "mesh", None) or {}).get("steps")
    if not steps:
        return None
    return sum(max(s["shard_host_s"], default=0.0) for s in steps) / len(steps) * 1e3
