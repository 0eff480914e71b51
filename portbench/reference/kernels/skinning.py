"""Linear-blend / SDEF skinning and vertex morphs (counterpart of
``reze_tpu/kernels/skinning.py``; plain torch, there is no kernel here).
The palette, morph weights and outputs may carry leading (character) axes;
the geometry is shared. The 3x4 skin products sum each coordinate in one
fixed order, as ``raster.project_corners`` does: a batched matrix product
may sum in another order for another crowd size, and a crowd's vertices
would then differ in the last bit from its characters' own; the morph
blend sums in float64 for the same reason (``math3d.morph_sum``)."""

from __future__ import annotations

import torch

from ..core import math3d as m3
from ..core.types import Geometry, Morphs, Skinning

Tensor = torch.Tensor


def morphed_positions(geom: Geometry, morphs: Morphs, weights: Tensor) -> Tensor:
    """Base positions + weighted vertex-morph offsets."""
    if morphs.n_morphs == 0:
        return geom.positions
    return geom.positions + m3.morph_sum(weights, morphs.offsets)


def blend_palette_gather(skin: Skinning, palette: Tensor) -> Tensor:
    """Per-vertex blended 3x4 skin matrix (..., V, 3, 4)."""
    mats = palette[..., skin.joints, :, :]  # (..., V, 4, 3, 4)
    return torch.sum(skin.weights[:, :, None, None] * mats, dim=-3)


def blend_palette_dense(skin: Skinning, palette: Tensor) -> Tensor:
    """Per-vertex blended 3x4 skin matrices (..., V, 3, 4) as one dense
    product of the (V, J) weights with the flattened palette (..., J, 12)."""
    flat = palette.reshape(palette.shape[:-2] + (12,))
    return torch.matmul(skin.weights_dense, flat).reshape(flat.shape[:-2] + (-1, 3, 4))


def _linear(m: Tensor, v: Tensor) -> Tensor:
    """(..., V, 3, k >= 3) matrices' first three columns on (..., V, 3),
    summed (x + y) + z."""
    return ((m[..., 0] * v[..., 0, None] + m[..., 1] * v[..., 1, None])
            + m[..., 2] * v[..., 2, None])


def _affine(m: Tensor, p: Tensor) -> Tensor:
    """(..., V, 3, 4) matrices on points (..., V, 3), summed ((x + y) + z) + t."""
    return _linear(m, p) + m[..., 3]


def apply_skin(mats: Tensor, positions: Tensor, normals: Tensor) -> tuple[Tensor, Tensor]:
    """Per-vertex 3x4 matrices on positions (affine) and normals (linear)."""
    pos = _affine(mats, positions)
    nrm = _linear(mats, normals)
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True), min=1e-8)
    return pos, nrm


def _sdef_positions(skin: Skinning, palette: Tensor, world_quat_palette: Tensor,
                    positions: Tensor) -> tuple[Tensor, Tensor]:
    """Spherical deform for SDEF vertices (MMD formulation)."""
    j0, j1 = skin.joints[:, 0], skin.joints[:, 1]
    w0, w1 = skin.weights[:, 0:1], skin.weights[:, 1:2]
    m0, m1 = palette[..., j0, :, :], palette[..., j1, :, :]
    q = m3.quat_slerp(world_quat_palette[..., j0, :], world_quat_palette[..., j1, :], w1[:, 0])
    c = skin.sdef_c
    rw = skin.sdef_r0 * w0 + skin.sdef_r1 * w1
    cr0 = (c + (c + skin.sdef_r0 - rw)) * 0.5
    cr1 = (c + (c + skin.sdef_r1 - rw)) * 0.5

    center = _affine(m0, cr0) * w0 + _affine(m1, cr1) * w1
    return m3.quat_rotate(q, positions - c) + center, m3.mat3_from_quat(q)


def skin_vertices(geom: Geometry, skin: Skinning, palette: Tensor,
                  morphs: Morphs | None = None, morph_weights: Tensor | None = None,
                  world_quat_palette: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Morph blend -> LBS (and SDEF where flagged) -> (positions, normals)."""
    positions = (morphed_positions(geom, morphs, morph_weights)
                 if morphs is not None and morph_weights is not None
                 else geom.positions)
    pos, nrm = apply_skin(blend_palette_gather(skin, palette), positions, geom.normals)
    if skin.is_sdef is not None and world_quat_palette is not None:
        sdef_pos, sdef_rot = _sdef_positions(skin, palette, world_quat_palette, positions)
        sdef_nrm = _linear(sdef_rot, geom.normals)
        sdef_nrm = sdef_nrm / torch.clamp(
            torch.linalg.norm(sdef_nrm, dim=-1, keepdim=True), min=1e-8)
        sel = skin.is_sdef[:, None]
        pos = torch.where(sel, sdef_pos, pos)
        nrm = torch.where(sel, sdef_nrm, nrm)
    return pos, nrm
