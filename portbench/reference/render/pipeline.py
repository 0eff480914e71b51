"""The per-pass triangle gather and the default lights (a frozen copy of
the port's ``render/pipeline.py``, without its oracle renderer)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import DEFAULT_LIGHTS, MAX_LIGHTS, EngineConfig, Lights, ModelArrays
from . import raster

Tensor = torch.Tensor


class _PassData(NamedTuple):
    corners_clip: Tensor  # (T, 3, 4)
    corner_uv: Tensor  # (T, 3, 2)
    corner_nrm: Tensor  # (T, 3, 3)
    corner_pos: Tensor  # (T, 3, 3)
    tri_mat: Tensor  # (T,)
    valid: Tensor  # (T,) bool


def _gather_pass(model: ModelArrays, pos: Tensor, nrm: Tensor, view_proj: Tensor,
                 cls: int, outline: bool, outline_scale: float,
                 uvs: Tensor | None = None) -> _PassData:
    """The draw class's padded triangle slice, projected to clip space.
    Outline passes draw the MMD inverted hull: corners pushed out along the
    skinned normal by ``edge_size * outline_scale``. A crowd's ``pos``,
    ``nrm``, ``uvs`` and ``view_proj`` carry a leading character axis, and
    so do the corners it returns."""
    geom = model.geometry
    if outline:
        ranges, tris_all, mats_all = (geom.outline_class_ranges, geom.outline_tris,
                                      geom.outline_tri_mat)
    else:
        ranges, tris_all, mats_all = geom.class_ranges, geom.tris, geom.tri_mat
    start, count, padded = ranges[cls]
    tris = tris_all[start:start + padded]
    tri_mat = mats_all[start:start + padded]
    valid = torch.arange(padded, device=tris.device) < count

    c_pos = pos[..., tris, :]
    c_nrm = nrm[..., tris, :]
    c_uv = (geom.uvs if uvs is None else uvs)[..., tris, :]
    if outline:
        edge = model.materials.edge_size[tri_mat][:, None, None]
        c_pos = c_pos + c_nrm * (edge * outline_scale)
    clip = raster.project_corners(c_pos, view_proj)
    return _PassData(clip, c_uv, c_nrm, c_pos, tri_mat, valid)


def make_lights(cfg: EngineConfig, device="cuda") -> Lights:
    direction = np.zeros((MAX_LIGHTS, 3), np.float32)
    color = np.zeros((MAX_LIGHTS, 3), np.float32)
    intensity = np.zeros(MAX_LIGHTS, np.float32)
    for i, (d, c, it) in enumerate(DEFAULT_LIGHTS):
        d = np.asarray(d, np.float32)
        direction[i] = d / np.linalg.norm(d)
        color[i] = c
        intensity[i] = it
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return Lights(
        ambient=f32(cfg.ambient),
        direction=f32(direction),
        color=f32(color),
        intensity=f32(intensity),
        count=torch.tensor(len(DEFAULT_LIGHTS), dtype=torch.int64, device=device),
    )
