"""Screen-space triangle setup (a frozen copy of the port's
``render/raster.py`` without the oracle's raster): clip -> screen,
cull, edge planes that are >= 0 inside, perspective 1/w."""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

# standard 4x MSAA sample offsets from the pixel centre
SAMPLE_OFFSETS = (
    (-2.0 / 16.0, -6.0 / 16.0),
    (6.0 / 16.0, -2.0 / 16.0),
    (-6.0 / 16.0, 2.0 / 16.0),
    (2.0 / 16.0, 6.0 / 16.0),
)

CULL_NONE = 0
CULL_FRONT = 1
CULL_BACK = 2


class TriSetup(NamedTuple):
    ea: Tensor  # (T, 3) edge x-coefficient
    eb: Tensor  # (T, 3) edge y-coefficient
    ec: Tensor  # (T, 3) edge constant
    z: Tensor  # (T, 3) corner NDC depth
    inv_w: Tensor  # (T, 3) corner 1 / clip w
    inv_area2: Tensor  # (T,) 1 / (2 |area|)
    sx: Tensor  # (T, 3) screen x
    sy: Tensor  # (T, 3) screen y
    valid: Tensor  # (T,) bool


def project_corners(corners_world: Tensor, view_proj: Tensor) -> Tensor:
    """(..., T, 3, 3) world corners -> (..., T, 3, 4) clip coordinates; a
    crowd's (C, 4, 4) ``view_proj`` projects each character's own. Each
    coordinate is summed in one fixed order, ((x + y) + z) + w: a matrix
    product may sum in another order for another batch size, and then a
    crowd's corners would differ in the last bit from its characters' own."""
    vp = view_proj[..., None, None, :, :]
    p = corners_world[..., None, :]
    return ((vp[..., 0] * p[..., 0] + vp[..., 1] * p[..., 1]) + vp[..., 2] * p[..., 2]) + vp[..., 3]


def setup_triangles(corners_clip: Tensor, valid: Tensor, width: int, height: int,
                    cull: int) -> TriSetup:
    w = corners_clip[..., 3]
    ok = valid & torch.all(w > 1e-6, dim=-1)
    safe_w = torch.where(torch.abs(w) > 1e-6, w, torch.ones_like(w))
    inv_w = 1.0 / safe_w
    ndc = corners_clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] + 1.0) * (0.5 * width)
    sy = (1.0 - ndc[..., 1]) * (0.5 * height)
    z = ndc[..., 2]

    # signed screen area * 2 (y down): NDC-CCW ("front") is negative here
    area2 = ((sx[..., 1] - sx[..., 0]) * (sy[..., 2] - sy[..., 0])
             - (sy[..., 1] - sy[..., 0]) * (sx[..., 2] - sx[..., 0]))
    is_front = area2 < 0.0
    if cull == CULL_FRONT:
        ok = ok & ~is_front
    elif cull == CULL_BACK:
        ok = ok & is_front
    ok = ok & (torch.abs(area2) > 1e-12)

    orient = torch.where(area2 < 0, 1.0, -1.0)
    # edge k is opposite corner k: (v1, v2), (v2, v0), (v0, v1)
    # (v1, v2, v0) and (v2, v0, v1) as rolls: indexing with a list would
    # copy it to the device and wait for the stream
    ax_, ay_ = torch.roll(sx, -1, -1), torch.roll(sy, -1, -1)
    bx_, by_ = torch.roll(sx, 1, -1), torch.roll(sy, 1, -1)
    ea = (by_ - ay_) * orient[..., None]
    eb = (ax_ - bx_) * orient[..., None]
    ec = -(ea * ax_ + eb * ay_)
    inv_area2 = 1.0 / torch.clamp(torch.abs(area2), min=1e-12)
    return TriSetup(ea, eb, ec, z, inv_w, inv_area2, sx, sy, ok)


