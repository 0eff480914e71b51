"""pose_ms.crowd: the crowd step span's self time per step, in milliseconds:
the call less its physics and render spans (sampling, morphs, IK, FK,
skinning over the crowd axis)."""

from portbench import trace


def read(run):
    return trace.self_ms(run, "call", ("physics", "render"))
