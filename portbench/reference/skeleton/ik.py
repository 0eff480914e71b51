"""CCD inverse kinematics for PMX IK chains (counterpart of
``reze_tpu/skeleton/ik.py``).

Per chain, ``loop_count`` iterations over the links (closest to the
effector first) each rotate one link so the effector approaches the IK
handle, with the step angle clamped to ``limit_angle * (link + 1)`` and
optional per-link Euler limits. All chains solve together: the chain
dimension is a batch axis, and iterations a chain does not run are masked.
Pose tensors may carry leading (character) axes; the chains are shared.
"""

from __future__ import annotations

import torch

from ..core import math3d as m3
from ..core.types import IKChains, Skeleton
from . import fk

Tensor = torch.Tensor


def _axis_angle_quat(axis: Tensor, angle: Tensor) -> Tensor:
    half = 0.5 * angle
    return torch.cat([axis * torch.sin(half)[..., None], torch.cos(half)[..., None]], dim=-1)


def _chain_fk(rots, bq, bp, pvalid, ppos):
    """Incremental FK down each chain's path -> world (q, p) per entry,
    (..., C, L+1, 4) and (..., C, L+1, 3)."""
    qs, ps = [], []
    q_acc, p_acc = bq, bp
    for i in range(rots.shape[-2]):
        v = pvalid[:, i, None]
        q_new = m3.quat_mul(q_acc, rots[..., i, :])
        p_new = p_acc + m3.quat_rotate(q_acc, ppos[..., i, :])
        q_acc = torch.where(v, q_new, q_acc)
        p_acc = torch.where(v, p_new, p_acc)
        qs.append(q_acc)
        ps.append(p_acc)
    return torch.stack(qs, -2), torch.stack(ps, -2)


def solve_ik(skel: Skeleton, ik: IKChains, local_rot: Tensor, local_trans: Tensor
             ) -> Tensor:
    """-> local rotations with IK applied."""
    if ik.n_chains == 0:
        return local_rot
    wq, wp = fk.world_transforms(skel, local_rot, local_trans)
    rot_eff, pos_local = fk.effective_locals(skel, local_rot, local_trans)

    c, l = ik.c, ik.l
    links = ik.links
    links_safe = torch.clamp(links, min=0)
    link_valid = links >= 0
    ar = torch.arange(l, device=links.device)
    top_idx = torch.argmax(torch.where(link_valid, ar[None, :], torch.full_like(links, -1)), dim=1)
    top_bone = torch.gather(links_safe, 1, top_idx[:, None])[:, 0]
    base_bone = skel.parent[top_bone]
    has_base = (base_bone >= 0)[:, None]
    base_safe = torch.clamp(base_bone, min=0)
    ident = m3.const((0.0, 0.0, 0.0, 1.0), wq.dtype, wq.device)
    bq = torch.where(has_base, wq[..., base_safe, :], ident)
    bp = torch.where(has_base, wp[..., base_safe, :], torch.zeros_like(wp[..., base_safe, :]))

    target_pos = wp[..., torch.clamp(ik.ik_bone, min=0), :]  # (..., C, 3) fixed IK handle
    effector = torch.clamp(ik.target, min=0)
    # path = [link[L-1], ..., link[0], effector]
    path = torch.cat([links_safe.flip(1), effector[:, None]], dim=1)  # (C, L+1)
    path_valid = torch.cat([link_valid.flip(1),
                            torch.ones((c, 1), dtype=torch.bool, device=links.device)], dim=1)
    ppos = pos_local[..., path, :]
    rots = rot_eff[..., path, :].clone()  # (..., C, L+1, 4)

    for it in range(ik.max_loops):
        running = it < ik.loop_count  # (C,)
        for li in range(l):
            pi = l - 1 - li
            qs, ps = _chain_fk(rots, bq, bp, path_valid, ppos)
            link_q, link_p, eff_p = qs[..., pi, :], ps[..., pi, :], ps[..., l, :]
            inv = m3.quat_conj(link_q)
            v1 = m3.quat_rotate(inv, eff_p - link_p)
            v2 = m3.quat_rotate(inv, target_pos - link_p)
            v1 = v1 / torch.clamp(torch.linalg.norm(v1, dim=-1, keepdim=True), min=1e-8)
            v2 = v2 / torch.clamp(torch.linalg.norm(v2, dim=-1, keepdim=True), min=1e-8)
            dot = torch.clamp(torch.sum(v1 * v2, dim=-1), -1.0, 1.0)
            angle = torch.minimum(torch.arccos(dot), ik.limit_angle * (li + 1.0))
            axis = torch.linalg.cross(v1, v2)
            axis_n = torch.linalg.norm(axis, dim=-1)
            axis = axis / torch.clamp(axis_n, min=1e-8)[..., None]
            dq = _axis_angle_quat(axis, angle)
            ok = (axis_n > 1e-8) & (angle > 1e-7) & link_valid[:, li] & running
            new_rot = m3.quat_normalize(m3.quat_mul(rots[..., pi, :], dq))
            e = torch.clamp(m3.quat_to_euler_zxy(new_rot),
                            ik.link_limit_min[:, li], ik.link_limit_max[:, li])
            new_rot = torch.where(ik.link_has_limit[:, li, None],
                                  m3.quat_from_euler_zxy(e), new_rot)
            rots[..., pi, :] = torch.where(ok[..., None], new_rot, rots[..., pi, :])

    # scatter the solved link rotations back; invalid entries go to a
    # spare row so they never race a valid write
    lead, j = local_rot.shape[:-2], local_rot.shape[-2]
    flat_bones = torch.where(path_valid[:, :l], path[:, :l], j).reshape(-1)
    out = torch.cat([local_rot, local_rot[..., :1, :]], dim=-2)
    out = out.index_copy(len(lead), flat_bones, rots[..., :l, :].reshape(lead + (-1, 4)))
    return out[..., :j, :]
