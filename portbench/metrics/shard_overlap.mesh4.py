"""shard_overlap.mesh4: the shards' host time over the mesh steps' time, in
the window: each shard's ``crowd.step`` less its lane's waits for the host
turn and for its card (``crowd.turn``, ``crowd.drain``), summed, over the
``crowd.mesh_step`` spans. The mean number of lanes running host code at
once: 1.0 one at a time, 4.0 four shards' host code fully side by side.
None where the port has no ``crowd.mesh_step``."""


def read(run):
    steps = (getattr(run, "mesh", None) or {}).get("steps")
    if not steps:
        return None
    return sum(sum(s["shard_host_s"]) for s in steps) / sum(s["mesh_s"] for s in steps)
