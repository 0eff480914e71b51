"""render_ms.mesh4: the host milliseconds of a mesh step in the shards'
``render`` spans (after the lane's wait for its card), all shards together,
averaged over the window's mesh steps. None where the port has no
``crowd.mesh_step``."""


def read(run):
    steps = (getattr(run, "mesh", None) or {}).get("steps")
    if not steps:
        return None
    return sum(s["render_s"] for s in steps) / len(steps) * 1e3
