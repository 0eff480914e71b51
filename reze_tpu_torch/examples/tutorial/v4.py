"""Tutorial v4 — bones, skinning and rotateBone.

Reference: web/app/tutorial/engines/v4.ts:47-723 adds the skeleton: local
bone rotations compose into world transforms by walking parents
(v4.ts:500-539), a compute shader builds skin matrices = world x
inverseBind (v4.ts:588-659), and the vertex shader blends four of them per
vertex (LBS). In torch, in order of appearance:

* FK: a loop over the bones in parent-before-child order, each composed
  with its parent's world transform, computed before it. (The engine
  replaces this chain with pointer doubling, ``skeleton/fk.py``; the
  sequential loop is the idea.)
* skin transforms: x -> rotate(world_q) (x - bind) + world_p for every
  vertex's four influences at once, one batched op over (V, 4).
* LBS: the weighted sum over the four influences.

``rotate_bone`` writes a quaternion into the local-rotation tensor and
calls the same function again. Two poses, the rest pose and one with 腰
(waist) and 首 (neck) turned, render side by side, like the reference's
canvas4 sliders. The written flagship-width model has no 腰: with
``--written-flagship`` 上半身 turns in its place.

    python -m reze_tpu_torch.examples.tutorial.v4 --written-flagship [--out v4.png]
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from . import WAIST, WRITTEN_WAIST, finish, rung_parser
from .. import device_of, parse, scene
from .v2 import SIZE, front_view_proj
from .v3 import load, render

YAW_30 = (0.0, 0.259, 0.0, 0.966)  # 30 degrees about y
NOD_15 = (0.131, 0.0, 0.0, 0.991)  # 15 degrees about x


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], -1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    u, w = q[..., :3], q[..., 3:4]
    return (v * (w * w - torch.sum(u * u, -1, keepdim=True))
            + 2.0 * u * torch.sum(u * v, -1, keepdim=True)
            + 2.0 * w * torch.linalg.cross(u, v))


def fk_sequential(parents: torch.Tensor, local_t: torch.Tensor, local_rot: torch.Tensor):
    """World (quat (J, 4), pos (J, 3)) per bone by walking parents
    (v4.ts:500-539). A parent comes before its child in a PMX (a parent
    not yet walked reads as the identity); the root's parent is -1.
    ``local_t`` is the parent-relative bind translation the loader stores
    (``Skeleton.bind_trans``). The parent ids are read to the host once."""
    dev = local_rot.device
    ident, zero = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev), torch.zeros(3, device=dev)
    wq, wp = [ident] * len(parents), [zero] * len(parents)
    for i, p in enumerate(parents.tolist()):
        pq, pp = (wq[p], wp[p]) if p >= 0 else (ident, zero)
        wq[i] = quat_mul(pq, local_rot[i])
        wp[i] = pp + quat_rotate(pq, local_t[i])
    return torch.stack(wq), torch.stack(wp)


def skin(m, local_rot: torch.Tensor):
    """FK -> skin transforms -> LBS of positions and normals."""
    skel, sk, g = m.skeleton, m.skinning, m.geometry
    wq, wp = fk_sequential(skel.parent, skel.bind_trans, local_rot)
    bind_pos = -skel.inv_bind_trans  # each bone's absolute bind position
    # bone b's skin transform: x -> rotate(wq) (x - bind) + wp, the
    # translation-only inverse bind of the reference (pmx-loader.ts:791-824)
    idx, wgt = sk.joints, sk.weights  # (V, 4) each
    rel = g.positions[:, None, :] - bind_pos[idx]  # (V, 4, 3)
    pos = torch.sum(wgt[..., None] * (quat_rotate(wq[idx], rel) + wp[idx]), 1)
    nrm = torch.sum(wgt[..., None] * quat_rotate(wq[idx], g.normals[:, None, :].expand(
        rel.shape)), 1)
    return pos, nrm


def posed_frame(m, local_rot: torch.Tensor, view_proj: torch.Tensor, size: int = SIZE):
    pos, nrm = skin(m, local_rot)
    g = dataclasses.replace(m.geometry, positions=pos, normals=nrm)
    return render(dataclasses.replace(m, geometry=g), view_proj, size)


def main(argv=None) -> dict:
    """-> {"image": (size, 2 * size, 3) uint8, "png": its path}."""
    args = parse(rung_parser(__doc__, SIZE, "tut_v4.png"), argv)
    dev = device_of(args)
    with scene(args) as (pmx, _):
        built = load(pmx, args.size, dev)
    m, name_to_id = built.arrays, built.bone_name_to_id
    vp = front_view_proj(dev)
    rest = torch.zeros((m.skeleton.j, 4), device=dev)
    rest[:, 3] = 1.0

    def rotate_bone(rot, name, quat):
        rot = rot.clone()
        rot[name_to_id[name]] = torch.tensor(quat, device=dev)
        return rot

    posed = rotate_bone(rest, WRITTEN_WAIST if args.written_flagship else WAIST, YAW_30)
    posed = rotate_bone(posed, "首", NOD_15)
    img = torch.cat([posed_frame(m, rest, vp, args.size), posed_frame(m, posed, vp, args.size)],
                    dim=1)
    return finish(img, args.out, "v4")


if __name__ == "__main__":
    main(sys.argv[1:])
