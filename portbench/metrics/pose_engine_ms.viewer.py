"""pose_engine_ms.viewer: the ``Engine.render`` span's self time per frame, in
milliseconds: the call less its physics and render spans (sampling, morphs,
IK, FK, skinning, the camera, the uint8 conversion and the readback)."""

from portbench import trace


def read(run):
    return trace.self_ms(run, "call", ("physics", "render"))
