"""pose_ms.mesh4: the host milliseconds of a mesh step in the shards' pose
and step code, all shards together: each shard's ``crowd.step`` less its
lane's waits and its ``physics`` and ``render`` spans, averaged over the
window's mesh steps. None where the port has no ``crowd.mesh_step``."""


def read(run):
    steps = (getattr(run, "mesh", None) or {}).get("steps")
    if not steps:
        return None
    return sum(sum(s["shard_host_s"]) - s["physics_s"] - s["render_s"]
               for s in steps) / len(steps) * 1e3
