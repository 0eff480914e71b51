"""Peaks of one NVIDIA H100 (SXM, HBM3; NVIDIA's data sheet, dense rates at
the full 700 W power limit) and the least work of a frame, counted from
the frame's inputs and output, never from the port's own tables: a later
change of tiling, pairing or padding leaves the count as it is.

A frame's render reads each drawn triangle's projected vertex attributes
once (a material pass: clip position, uv and normal at each of three
corners; an outline pass: the clip position) and writes the frame's
output planes once (height x width x 3 float32). Its operations are not
counted, so the bytes bind, and the least time is a lower bound.
"""

from __future__ import annotations

from .reference.core.build import _material_class
from .reference.core.types import CLASS_EYE, CLASS_HAIR, CLASS_OPAQUE, CLASS_TRANSPARENT

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

F32 = 4
MATERIAL_CORNER_FLOATS = 4 + 2 + 3  # clip xyzw, uv, normal
OUTLINE_CORNER_FLOATS = 4  # clip xyzw
OUTPUT_CHANNELS = 3

# (draw class, outline) per pass, in the engine's draw order
PASSES = ((CLASS_OPAQUE, False), (CLASS_EYE, False), (CLASS_OPAQUE, True), (CLASS_HAIR, False),
          (CLASS_HAIR, True), (CLASS_TRANSPARENT, False), (CLASS_TRANSPARENT, True))


def pass_triangles(pmx) -> list[int]:
    """Triangles drawn by each of the seven passes of a parsed or generated
    PMX model (``reference.formats.pmx.PMXModel``)."""
    counts = []
    for cls, outline in PASSES:
        counts.append(sum(m.index_count // 3 for m in pmx.materials
                          if _material_class(m) == cls and (m.has_edge or not outline)))
    return counts


def frame_bytes(pmx, width: int, height: int) -> int:
    """Bytes one character's frame must move at least."""
    read = 0
    for (_, outline), t in zip(PASSES, pass_triangles(pmx)):
        read += t * 3 * (OUTLINE_CORNER_FLOATS if outline else MATERIAL_CORNER_FLOATS) * F32
    return read + width * height * OUTPUT_CHANNELS * F32


def least_seconds(nbytes: float, ops: float = 0.0) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
