"""Skeleton forward kinematics by pointer doubling (counterpart of
``reze_tpu/skeleton/fk.py``).

Local transform = T(bind + anim) * R * T(append move); append (grant)
rotation premultiplies slerp(identity, +/- parent local rotation, |ratio|).
World transforms compose with the 2^k-th ancestor in ``doubling_steps``
vectorized steps. Pose tensors may carry leading (character) axes; the
skeleton is shared.
"""

from __future__ import annotations

import torch

from ..core import math3d as m3
from ..core.types import Skeleton

Tensor = torch.Tensor


def effective_locals(skel: Skeleton, local_rot: Tensor, local_trans: Tensor
                     ) -> tuple[Tensor, Tensor]:
    """Apply append/grant inheritance -> per-bone (rot, parent-space pos)."""
    ap = skel.append_parent
    ap_safe = torch.clamp(ap, min=0)
    ratio = torch.clamp(skel.append_ratio, -1.0, 1.0)
    has_rot = (ap >= 0) & skel.append_rotate & (torch.abs(ratio) > 1e-6)
    has_move = (ap >= 0) & skel.append_move & (torch.abs(ratio) > 1e-6)

    ap_rot = local_rot[..., ap_safe, :]
    signed = torch.where((ratio < 0)[:, None], m3.quat_conj(ap_rot), ap_rot)
    ident = torch.zeros_like(ap_rot)
    ident[..., 3] = 1.0
    q_app = m3.quat_slerp(ident, signed, torch.abs(ratio))
    rot_eff = torch.where(has_rot[:, None], m3.quat_mul(q_app, local_rot), local_rot)

    # append move uses the unclamped ratio
    add = torch.where(has_move[:, None],
                      local_trans[..., ap_safe, :] * skel.append_ratio[:, None],
                      torch.zeros_like(local_trans))
    pos = skel.bind_trans + local_trans + m3.quat_rotate(rot_eff, add)
    return rot_eff, pos


def compose_world(skel: Skeleton, rot: Tensor, pos: Tensor) -> tuple[Tensor, Tensor]:
    """world[i] = world[parent[i]] * local[i] by pointer doubling."""
    q, p, anc = rot, pos, skel.parent
    for _ in range(skel.doubling_steps):
        anc_safe = torch.clamp(anc, min=0)
        has = (anc >= 0)[:, None]
        qa, pa = q[..., anc_safe, :], p[..., anc_safe, :]
        q, p = (torch.where(has, m3.quat_mul(qa, q), q),
                torch.where(has, pa + m3.quat_rotate(qa, p), p))
        anc = torch.where(anc >= 0, anc[anc_safe], torch.full_like(anc, -1))
    return q, p


def world_transforms(skel: Skeleton, local_rot: Tensor, local_trans: Tensor
                     ) -> tuple[Tensor, Tensor]:
    """Full pose -> (world_quat (..., J, 4), world_pos (..., J, 3))."""
    rot, pos = effective_locals(skel, local_rot, local_trans)
    return compose_world(skel, rot, pos)


def world_matrices(skel: Skeleton, local_rot: Tensor, local_trans: Tensor) -> Tensor:
    """Full pose -> world matrices (..., J, 4, 4)."""
    q, p = world_transforms(skel, local_rot, local_trans)
    return m3.mat4_from_pos_quat(p, q)


def skin_palette(skel: Skeleton, world_quat: Tensor, world_pos: Tensor) -> Tensor:
    """Per-bone skin matrices (..., J, 3, 4): world * T(inverse bind)."""
    rot3 = m3.mat3_from_quat(world_quat)
    trans = world_pos + m3.quat_rotate(world_quat, skel.inv_bind_trans)
    return torch.cat([rot3, trans[..., :, None]], dim=-1)
