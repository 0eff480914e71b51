"""Synthetic inputs for tests and the GPU smoke run.

``make_test_model`` builds the same tiny but complete model as
``reze_tpu.testing.make_test_model`` (identical arrays for the same
arguments): a bone chain with an append, one IK chain, one textured quad
per draw class, one vertex morph and two rigid bodies. ``make_physics_rig``
builds a seeded hair-and-skirt rig at the flagship model's physics width.
``random_pass_inputs``
makes seeded random triangles for the pair-pack and kernel checks, and
``random_stack`` a seeded fragment stack for the stack shade.
``make_test_track`` makes a seeded keyframe clip for the synthetic model,
and ``stack_tables`` stacks one character's tables into a crowd's.

Files: ``write_pmx``, ``write_vmd``, ``write_png``, ``write_bmp`` and
``write_tga`` write PMX 2.0/2.1, VMD and texture files that both packages'
loaders read; ``make_pmx_spec(seed, scale)`` makes a seeded humanoid model
with its textures and clip (``scale="small"`` for the CPU tests,
``"flagship"`` at the flagship model's widths), and ``write_scene`` writes
one into a directory.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import struct

import numpy as np

from . import bridge
from .core import types as T
from .core.build import build_mip_chain, build_quad_chain, build_quad_flat
from .formats.pmx import (
    DEFORM_BDEF1,
    DEFORM_BDEF2,
    DEFORM_BDEF4,
    DEFORM_QDEF,
    DEFORM_SDEF,
    FLAG_APPEND_MOVE,
    FLAG_APPEND_ROTATE,
    FLAG_AXIS_LIMIT,
    FLAG_EXTERNAL_PARENT,
    FLAG_IK,
    FLAG_LOCAL_AXIS,
    FLAG_TAIL_IS_BONE,
    MAT_FLAG_DOUBLE_SIDED,
    MAT_FLAG_EDGE,
    PMXIK,
    PMXBone,
    PMXIKLink,
    PMXJoint,
    PMXMaterial,
    PMXModel,
    PMXMorph,
    PMXRigidBody,
)
from .formats.image import write_png  # noqa: F401  (one of this module's writers)
from .formats.vmd import VMDMotion


def make_test_model(n_bones: int = 8, j_pad: int = 8, v_pad: int = 64,
                    tex_hw: tuple[int, int] = (8, 8),
                    device="cuda") -> T.ModelArrays:
    j = j_pad
    parent = np.full(j, -1, np.int32)
    bind = np.zeros((j, 3), np.float32)
    for i in range(1, n_bones):
        parent[i] = i - 1
        bind[i] = (0, 1, 0)
    abspos = np.cumsum(bind, axis=0)
    ap_parent = np.full(j, -1, np.int32)
    ap_ratio = np.zeros(j, np.float32)
    ap_rot = np.zeros(j, bool)
    if n_bones >= 4:
        ap_parent[3] = 1
        ap_ratio[3] = 0.5
        ap_rot[3] = True
    steps = max(1, int(np.ceil(np.log2(n_bones + 1))))
    skeleton = T.Skeleton(
        parent=parent, bind_trans=bind, inv_bind_trans=-abspos,
        append_parent=ap_parent, append_ratio=ap_ratio, append_rotate=ap_rot,
        append_move=np.zeros(j, bool), after_physics=np.zeros(j, bool),
        n_bones=n_bones, doubling_steps=steps,
    )
    ik = T.IKChains(
        ik_bone=np.array([n_bones - 1], np.int32),
        target=np.array([n_bones - 2], np.int32),
        loop_count=np.array([4], np.int32),
        limit_angle=np.array([1.0], np.float32),
        links=np.array([[n_bones - 3, n_bones - 4]], np.int32),
        link_has_limit=np.zeros((1, 2), bool),
        link_limit_min=np.zeros((1, 2, 3), np.float32),
        link_limit_max=np.zeros((1, 2, 3), np.float32),
        max_loops=4, n_chains=1,
    )

    # one quad per class, stacked vertically, skinned to bones
    positions = np.zeros((v_pad, 3), np.float32)
    normals = np.zeros((v_pad, 3), np.float32)
    normals[:, 2] = -1.0
    uvs = np.zeros((v_pad, 2), np.float32)
    tris, tri_mat = [], []
    for c in range(4):
        base = c * 4
        y0 = float(c)
        quad = [(-0.5, y0, 0.0), (0.5, y0, 0.0), (0.5, y0 + 0.8, 0.0), (-0.5, y0 + 0.8, 0.0)]
        for k, p in enumerate(quad):
            positions[base + k] = p
            uvs[base + k] = (k % 2, k // 2)
        tris += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        tri_mat += [c, c]
    t = len(tris)
    t_pad = T.round_up(t, 8)
    tris_arr = np.zeros((t_pad, 3), np.int32)
    tris_arr[:t] = tris
    mat_arr = np.zeros(t_pad, np.int32)
    mat_arr[:t] = tri_mat
    ranges = tuple((c * 2, 2, 2) if c < 3 else (6, 2, t_pad - 6) for c in range(4))
    geometry = T.Geometry(
        positions=positions, normals=normals, uvs=uvs,
        tris=tris_arr, tri_mat=mat_arr,
        # reversed winding: flat quads need the flip to behave like the
        # inverted hull of a closed mesh
        outline_tris=tris_arr[:, [0, 2, 1]].copy(), outline_tri_mat=mat_arr.copy(),
        n_vertices=16, class_ranges=ranges, outline_class_ranges=ranges,
    )

    joints4 = np.zeros((v_pad, 4), np.int32)
    weights4 = np.zeros((v_pad, 4), np.float32)
    joints4[:, 0] = np.minimum(np.arange(v_pad) // 4, n_bones - 1)
    weights4[:, 0] = 1.0
    dense = np.zeros((v_pad, j), np.float32)
    dense[np.arange(v_pad), joints4[:, 0]] = 1.0
    skinning = T.Skinning(
        joints=joints4, weights=weights4, weights_dense=dense,
        sdef_c=None, sdef_r0=None, sdef_r1=None, is_sdef=None,
    )

    m = 4
    lut = np.tile(np.linspace(0.5, 1.0, 256, dtype=np.float32)[None, :, None], (m, 1, 3))
    materials = T.Materials(
        alpha=np.array([1.0, 1.0, 1.0, 0.5], np.float32),
        diffuse_rgb=np.ones((m, 3), np.float32),
        edge_color=np.tile(np.array([0, 0, 0, 1], np.float32), (m, 1)),
        edge_size=np.ones(m, np.float32),
        tex_id=np.zeros(m, np.int32),
        toon_lut=lut,
        is_eye=np.array([False, True, False, False]),
        is_hair=np.array([False, False, True, False]),
        is_transparent=np.array([False, False, False, True]),
    )
    th, tw = tex_hw
    gy, gx = np.meshgrid(np.linspace(60, 220, th), np.linspace(40, 240, tw),
                         indexing="ij")
    texels = np.stack([gx, gy, 0.5 * (gx + gy), np.full((th, tw), 255.0)], -1)[None]
    tex_u8 = texels.astype(np.uint8)
    tex_sizes = np.array([[th, tw]], np.int32)
    mip_flat, mip_base = build_mip_chain(tex_u8, tex_sizes)
    atlas = T.TextureAtlas(texels=tex_u8, sizes=tex_sizes,
                           mip_flat=mip_flat, mip_base=mip_base,
                           mip_quad=build_quad_chain(mip_flat, mip_base, tex_sizes),
                           flat_quad=build_quad_flat(tex_u8, tex_sizes))

    morphs_off = np.zeros((2, v_pad, 3), np.float32)
    morphs_off[0, 0] = (0.0, 0.2, 0.0)
    morphs = empty_morph_tables(morphs_off, n_mats=1)

    # kinematic body on bone 1, dynamic on bone 2, one spring joint
    nb = nj = 8
    q0 = np.zeros((nb, 4), np.float32)
    q0[:, 3] = 1
    jq = np.zeros((nj, 4), np.float32)
    jq[:, 3] = 1
    bone_index = np.full(nb, -1, np.int32)
    bone_index[0] = 1
    bone_index[1] = 2
    is_dyn = np.zeros(nb, bool)
    is_dyn[1] = True
    zeros3 = np.zeros((nb, 3), np.float32)
    physics = T.PhysicsModel(
        bone_index=bone_index, shape=np.zeros(nb, np.int32),
        size=np.full((nb, 3), 0.3, np.float32),
        mass=np.where(is_dyn, 1.0, 0.0).astype(np.float32),
        inv_mass=np.where(is_dyn, 1.0, 0.0).astype(np.float32),
        inv_inertia_local=np.full((nb, 3), 10.0, np.float32),
        linear_damping=np.full(nb, 0.1, np.float32),
        angular_damping=np.full(nb, 0.1, np.float32),
        restitution=np.zeros(nb, np.float32), friction=np.full(nb, 0.5, np.float32),
        is_dynamic=is_dyn, no_contact=np.ones(nb, bool),
        group=np.zeros(nb, np.int32), collision_mask=np.zeros(nb, np.int32),
        body_offset_pos=zeros3, body_offset_quat=q0, bind_pos=zeros3.copy(),
        valid=np.array([True, True] + [False] * (nb - 2)),
        joint_body_a=np.array([0] + [-1] * (nj - 1), np.int32),
        joint_body_b=np.array([1] + [-1] * (nj - 1), np.int32),
        joint_pos_a=np.zeros((nj, 3), np.float32), joint_quat_a=jq,
        joint_pos_b=np.array([[0, -1, 0]] + [[0, 0, 0]] * (nj - 1), np.float32),
        joint_quat_b=jq.copy(),
        joint_lin_min=np.zeros((nj, 3), np.float32),
        joint_lin_max=np.zeros((nj, 3), np.float32),
        joint_ang_min=np.full((nj, 3), -2.0, np.float32),
        joint_ang_max=np.full((nj, 3), 2.0, np.float32),
        joint_spring_lin=np.zeros((nj, 3), np.float32),
        joint_spring_ang=np.full((nj, 3), 5.0, np.float32),
        joint_valid=np.array([True] + [False] * (nj - 1)),
        n_bodies=2, n_joints=1,
    )
    model = T.ModelArrays(
        skeleton=skeleton, ik=ik, skinning=skinning, geometry=geometry,
        materials=materials, atlas=atlas, morphs=morphs, physics=physics,
    )
    return bridge.from_jax_arrays(model, device)


def _np_quat_y(angle):
    """(..., 4) quaternions of rotations by ``angle`` about +Y."""
    angle = np.asarray(angle, np.float64)
    q = np.zeros(angle.shape + (4,))
    q[..., 1], q[..., 3] = np.sin(angle / 2), np.cos(angle / 2)
    return q


def _np_rotate_inv(q, v):
    """Rotate ``v`` by the inverse of the unit quaternion ``q``."""
    qv, w = -q[..., :3], q[..., 3:]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def make_physics_rig(seed: int, n_bodies: int = 257, n_joints: int = 406, device="cuda"):
    """A seeded procedural hair-and-skirt rig at the flagship model's
    physics width (257 bodies, 406 joints by default) -> (PhysicsModel,
    bone world rotations (J, 4), bone world positions (J, 3)), one bone
    per body, on ``device``.

    Five kinematic anchors (head and chest spheres, a hip box, two leg
    capsules); hair chains of four capsules ending in a sphere, hung from
    the head and swung 50 degrees out from vertical, so they fall and
    swing; a skirt of ``rows`` rings of thin boxes hung from the hips,
    each column a chain and each ring closed by cross joints with linear
    springs. Hair joints lock their linear axes, carry angular limits and,
    on every other chain, angular springs; skirt chain joints lock their
    linear axes and their twist; joints beyond these link neighbouring
    hair chains. The joints need several colours. Hair collides with the
    anchors and with the other parity of chains, the skirt with the hips
    and legs: several thousand candidate pairs against the default
    512-contact cap. Sizes, masses and damping are jittered by the seed.
    """
    rng = np.random.default_rng(seed)
    n_dyn = n_bodies - 5
    rows = 8 if n_dyn >= 128 else 4
    cols = (n_dyn // 2) // rows
    n_skirt = rows * cols
    n_hair = n_dyn - n_skirt
    chain_len = 4
    n_chains = -(-n_hair // chain_len)

    pos = np.zeros((n_bodies, 3))
    quat = np.zeros((n_bodies, 4))
    quat[:, 3] = 1.0
    shape = np.zeros(n_bodies, np.int32)
    size = np.zeros((n_bodies, 3))
    group = np.zeros(n_bodies, np.int32)
    mask = np.zeros(n_bodies, np.int32)
    # anchors: head, chest, hips, left and right leg
    pos[:5] = [(0, 16, 0), (0, 13, 0), (0, 10, 0), (-0.9, 7, 0), (0.9, 7, 0)]
    shape[:5] = [0, 0, 1, 2, 2]
    size[:5] = [(1.2, 0, 0), (1.5, 0, 0), (1.8, 0.6, 1.1), (0.8, 4.0, 0), (0.8, 4.0, 0)]
    group[:5] = [0, 0, 0, 4, 4]
    mask[:5] = [0b1110, 0b1110, 0b0110, 0b0100, 0b0100]

    joints = []  # (body a, body b, world anchor, per-joint kind)
    # hair: chain c from the head at angle th, tilted out by 50 degrees
    hair = np.arange(5, 5 + n_hair)
    level_of = {}
    for k, b in enumerate(hair):
        c, lvl = divmod(k, chain_len)
        th = 2 * np.pi * c / n_chains
        out = np.array([np.cos(th), 0.0, np.sin(th)])
        d = np.sin(np.radians(50)) * out - np.cos(np.radians(50)) * np.array([0, 1, 0])
        root = pos[0] + 1.25 * out
        pos[b] = root + d * 0.8 * (lvl + 0.5)
        last = lvl == chain_len - 1 or k == n_hair - 1
        shape[b] = 0 if last else 2
        size[b] = (0.12, 0, 0) if last else (0.1, 0.5, 0)
        group[b] = 1 if c % 2 == 0 else 3
        mask[b] = 0b0001 | (0b1000 if c % 2 == 0 else 0b0010)
        parent = 0 if lvl == 0 else b - 1
        joints.append((parent, b, root + d * 0.8 * lvl, "hair", c))
        level_of[(c, lvl)] = b
    # skirt: column c at angle ph, ring r flaring out and down
    for k in range(n_skirt):
        r, c = divmod(k, cols)
        b = 5 + n_hair + k
        ph = 2 * np.pi * c / cols
        rad = 2.2 + 0.35 * r
        pos[b] = (rad * np.cos(ph), 9.4 - 0.9 * r, rad * np.sin(ph))
        quat[b] = _np_quat_y(-ph)
        shape[b] = 1
        size[b] = (0.5, 0.45, 0.08)
        group[b], mask[b] = 2, 0b10001
        parent = 2 if r == 0 else b - cols
        joints.append((parent, b, (pos[parent] + pos[b]) / 2 if r else
                       pos[b] + (0, 0.45, 0), "skirt", c))
    for k in range(n_skirt):
        r, c = divmod(k, cols)
        b = 5 + n_hair + k
        nb = 5 + n_hair + r * cols + (c + 1) % cols
        joints.append((b, nb, (pos[b] + pos[nb]) / 2, "ring", c))
    extra = n_joints - len(joints)
    if extra < 0:
        raise ValueError(f"{n_joints} joints cannot hold the rig's {len(joints)}")
    for lvl in range(1, chain_len):
        for c in range(n_chains):
            a, b = level_of.get((c, lvl)), level_of.get(((c + 1) % n_chains, lvl))
            if extra and a is not None and b is not None and a != b:
                joints.append((a, b, (pos[a] + pos[b]) / 2, "link", c))
                extra -= 1
    if extra:
        raise ValueError(f"the rig cannot place {n_joints} joints")

    is_dyn = np.arange(n_bodies) >= 5
    mass = np.where(is_dyn, rng.uniform(0.5, 1.5, n_bodies), 0.0)
    size = size * np.where(is_dyn, rng.uniform(0.9, 1.1, n_bodies), 1.0)[:, None]
    r0, r1 = size[:, 0], size[:, 1]
    inertia = np.where(shape[:, None] == 1, (size[:, [1, 2, 0]] ** 2 + size[:, [2, 0, 1]] ** 2) / 3,
                       np.where(shape[:, None] == 2,
                                np.stack([(3 * r0 ** 2 + r1 ** 2) / 12, r0 ** 2 / 2,
                                          (3 * r0 ** 2 + r1 ** 2) / 12], 1),
                                0.4 * r0[:, None] ** 2)) * mass[:, None]
    inv_i = np.where(is_dyn[:, None], 1.0 / np.maximum(inertia, 1e-6), 0.0)

    nj = len(joints)
    ja = np.array([j[0] for j in joints], np.int32)
    jb = np.array([j[1] for j in joints], np.int32)
    anchor = np.stack([np.asarray(j[2], np.float64) for j in joints])
    kind = [j[3] for j in joints]
    lin_min, lin_max = np.zeros((nj, 3)), np.zeros((nj, 3))
    ang_min, ang_max = np.zeros((nj, 3)), np.zeros((nj, 3))
    k_lin, k_ang = np.zeros((nj, 3)), np.zeros((nj, 3))
    for i, (_, _, _, kd, c) in enumerate(joints):
        if kd == "hair":
            ang_min[i], ang_max[i] = -0.6, 0.6
            k_ang[i] = 20.0 if c % 2 == 0 else 0.0
        elif kd == "skirt":
            ang_min[i], ang_max[i] = (-0.5, 0.0, -0.3), (0.8, 0.0, 0.3)
            k_ang[i] = 10.0
        else:  # ring and hair links: stretchy, with linear springs
            lin_min[i], lin_max[i] = -0.3, 0.3
            ang_min[i], ang_max[i] = -1.0, 1.0
            k_lin[i] = 50.0
    qa, qb = quat[ja], quat[jb]
    conj = lambda q: q * (-1.0, -1.0, -1.0, 1.0)  # noqa: E731
    pm = T.PhysicsModel(
        bone_index=np.arange(n_bodies, dtype=np.int32), shape=shape,
        size=size.astype(np.float32), mass=mass.astype(np.float32),
        inv_mass=np.where(is_dyn, 1.0 / np.maximum(mass, 1e-6), 0.0).astype(np.float32),
        inv_inertia_local=inv_i.astype(np.float32),
        linear_damping=np.where(is_dyn, rng.uniform(0.5, 0.9, n_bodies), 0.0).astype(np.float32),
        angular_damping=np.where(is_dyn, rng.uniform(0.8, 0.99, n_bodies), 0.0).astype(np.float32),
        restitution=rng.choice([0.0, 0.0, 0.2], n_bodies).astype(np.float32),
        friction=np.full(n_bodies, 0.5, np.float32), is_dynamic=is_dyn,
        no_contact=np.zeros(n_bodies, bool), group=group, collision_mask=mask,
        body_offset_pos=np.zeros((n_bodies, 3), np.float32),
        body_offset_quat=np.tile(np.array([0, 0, 0, 1], np.float32), (n_bodies, 1)),
        bind_pos=pos.astype(np.float32), valid=np.ones(n_bodies, bool),
        joint_body_a=ja, joint_body_b=jb,
        joint_pos_a=_np_rotate_inv(qa, anchor - pos[ja]).astype(np.float32),
        joint_quat_a=conj(qa).astype(np.float32),
        joint_pos_b=_np_rotate_inv(qb, anchor - pos[jb]).astype(np.float32),
        joint_quat_b=conj(qb).astype(np.float32),
        joint_lin_min=lin_min.astype(np.float32), joint_lin_max=lin_max.astype(np.float32),
        joint_ang_min=ang_min.astype(np.float32), joint_ang_max=ang_max.astype(np.float32),
        joint_spring_lin=k_lin.astype(np.float32), joint_spring_ang=k_ang.astype(np.float32),
        joint_valid=np.ones(nj, bool), n_bodies=n_bodies, n_joints=nj)
    return (bridge.from_jax_arrays(pm, device),
            bridge.from_jax_arrays(quat.astype(np.float32), device),
            bridge.from_jax_arrays(pos.astype(np.float32), device))


def make_test_track(seed: int, j_pad: int = 8, nm_pad: int = 2, n_keys: int = 4,
                    device="cuda") -> T.AnimationTrack:
    """A seeded keyframe clip of ``duration`` 2 s for a model of ``j_pad``
    bones and ``nm_pad`` morphs: every bone but the last has a track of 2 to
    ``n_keys`` keys (times padded with +inf) of rotations up to 0.6 rad,
    small translations and random Bezier easing; every morph a linear track
    of weights in [0, 1]. ``device=None`` keeps numpy leaves (for the JAX
    package's dataclass)."""
    rng = np.random.default_rng(seed)
    nk = rng.integers(2, n_keys + 1, j_pad)
    times = np.full((j_pad, n_keys), np.inf, np.float32)
    for b in range(j_pad):
        times[b, :nk[b]] = np.sort(rng.uniform(0.0, 2.0, nk[b]))
        times[b, 0] = 0.0
    axis = rng.normal(size=(j_pad, n_keys, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    half = rng.uniform(0.0, 0.3, (j_pad, n_keys, 1))
    rots = np.concatenate([axis * np.sin(half), np.cos(half)], -1).astype(np.float32)
    interp = rng.uniform(0.0, 1.0, (j_pad, n_keys, 4, 4)).astype(np.float32)
    km = n_keys
    mtimes = np.sort(rng.uniform(0.0, 2.0, (nm_pad, km)), axis=1).astype(np.float32)
    mtimes[:, 0] = 0.0
    track = T.AnimationTrack(
        times=times, rotations=rots,
        positions=rng.uniform(-0.1, 0.1, (j_pad, n_keys, 3)).astype(np.float32),
        interp=interp, n_keys=nk.astype(np.int32),
        has_track=np.arange(j_pad) < j_pad - 1,
        morph_times=mtimes, morph_values=rng.uniform(0, 1, (nm_pad, km)).astype(np.float32),
        morph_n_keys=np.full(nm_pad, km, np.int32), duration=2.0)
    return track if device is None else bridge.from_jax_arrays(track, device)


def stack_tables(tables: list):
    """One character's tables per character (a NamedTuple of tensors, e.g.
    ``frame_gpu.FrameTables``, or a dataclass such as an
    ``AnimationTrack``) -> the crowd's, every tensor stacked on a leading
    character axis."""
    import dataclasses

    import torch

    first = tables[0]
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: torch.stack([getattr(t, f.name) for t in tables])
            for f in dataclasses.fields(first) if isinstance(getattr(first, f.name), torch.Tensor)})
    return type(first)(*(torch.stack(list(f)) for f in zip(*tables)))


def empty_morph_tables(offsets: np.ndarray, n_mats: int) -> T.Morphs:
    """Morphs with only vertex offsets populated (numpy leaves)."""
    nm = offsets.shape[0]
    return T.Morphs(
        offsets=offsets,
        bone_trans=np.zeros((1, 1, 3), np.float32),
        bone_rotvec=np.zeros((1, 1, 3), np.float32),
        uv_offsets=np.zeros((1, 1, 2), np.float32),
        mat_alpha_dmul=np.zeros((nm, n_mats), np.float32),
        mat_alpha_add=np.zeros((nm, n_mats), np.float32),
        mat_edge_a_dmul=np.zeros((nm, n_mats), np.float32),
        mat_edge_a_add=np.zeros((nm, n_mats), np.float32),
        n_morphs=nm,
    )


def random_shade_inputs(seed: int, n_groups: int = 3) -> dict:
    """Seeded shade tables for the kernel checks, as numpy: ``n_groups``
    toon ramps and edge colours, three textures of odd sizes (the last one
    flagged untextured) with their dense mip chain, an eye position and an
    inverse view-projection. Keys: knot_tab, tex_tab, edge_tab,
    atlas_stride, texels, mip_flat, mip_quad (the chain's quad footprints),
    eye_pos, inv_vp."""
    rng = np.random.default_rng(seed)
    sizes = np.array([[8, 8], [7, 11], [16, 4]], np.int32)
    n, mh, mw = len(sizes), 16, 16
    texels = rng.integers(0, 256, (n, mh, mw, 4)).astype(np.uint8)
    mip_flat, mip_base = build_mip_chain(texels, sizes)
    valid = np.array([1.0, 1.0, 0.0], np.float32)
    tex_tab = np.concatenate([
        sizes.astype(np.float32), (np.arange(n) * mh * mw)[:, None].astype(np.float32),
        valid[:, None], mip_base.astype(np.float32)], axis=1)
    return dict(
        knot_tab=rng.uniform(0.3, 1.0, (n_groups, 27)).astype(np.float32),
        tex_tab=tex_tab[:n_groups],
        edge_tab=rng.uniform(0.0, 1.0, (n_groups, 3)).astype(np.float32),
        atlas_stride=mw, texels=texels, mip_flat=mip_flat,
        mip_quad=build_quad_chain(mip_flat, mip_base, sizes),
        eye_pos=rng.normal(size=3).astype(np.float32),
        inv_vp=rng.normal(size=(4, 4)).astype(np.float32),
    )


def random_pass_inputs(seed: int, n_tris: tuple[int, ...], n_groups: int = 3):
    """Seeded random triangles for each of the 7 raster passes, as numpy.

    Per pass: ``corners_clip`` (T, 3, 4) in clip space with w in [0.5, 2]
    (about a tenth of the triangles get a w <= 0 corner and are rejected at
    setup), ``corner_uv`` (T, 3, 2), ``corner_nrm`` (T, 3, 3), ``valid``
    (T,) and per-triangle material columns ``alpha``, ``is_hair``,
    ``ramp``, ``tex``, ``edge`` with group ids below ``n_groups``.
    Triangles are small relative to the frame, so a tile segment of the
    first (largest) pass holds more than one 128-pair chunk.
    """
    rng = np.random.default_rng(seed)
    out = []
    for t in n_tris:
        center = rng.uniform(-1.0, 1.0, (t, 1, 2))
        spread = rng.uniform(0.05, 0.5, (t, 1, 1))
        xy = center + spread * rng.normal(size=(t, 3, 2))
        w = rng.uniform(0.5, 2.0, (t, 3))
        w[rng.random(t) < 0.1, 0] = -0.5
        z = rng.uniform(0.05, 0.95, (t, 3))
        clip = np.concatenate(
            [xy * w[..., None], (z * w)[..., None], w[..., None]], axis=-1)
        nrm = rng.normal(size=(t, 3, 3))
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        out.append(dict(
            corners_clip=clip.astype(np.float32),
            corner_uv=rng.uniform(-0.5, 1.5, (t, 3, 2)).astype(np.float32),
            corner_nrm=nrm.astype(np.float32),
            valid=rng.random(t) < 0.95,
            alpha=rng.choice([1.0, 1.0, 0.5, 0.2], t).astype(np.float32),
            is_hair=(rng.random(t) < 0.3).astype(np.float32),
            ramp=rng.integers(0, n_groups, t).astype(np.float32),
            tex=rng.integers(0, n_groups, t).astype(np.float32),
            edge=rng.integers(0, n_groups, t).astype(np.float32),
        ))
    return out


def _random_pass_parts(seed: int, n_tris: tuple[int, ...], hp: int, wp: int, device,
                       pairs_per_tri: float = 4.0):
    """Per pass, ``frame_gpu.pack_pass_part``'s output for
    :func:`random_pass_inputs`, with the engine's per-pass culling and, by
    default, its pair capacity (``pairs_per_tri`` pairs per triangle plus
    1024)."""
    import torch

    from .kernels import frame_gpu as FG
    from .render import raster
    from .render.pipeline_gpu import _PASS_SPECS

    parts = []
    for (_, cull, outline), d in zip(_PASS_SPECS, random_pass_inputs(seed, n_tris)):
        t = {k: torch.as_tensor(v, device=device) for k, v in d.items()}
        tri = raster.setup_triangles(t["corners_clip"], t["valid"], wp, hp, cull)
        cap = -(-int(len(d["valid"]) * pairs_per_tri + 1024) // FG.CHUNK) * FG.CHUNK
        parts.append(FG.pack_pass_part(
            tri, t["corner_uv"], t["corner_nrm"], t["alpha"], t["is_hair"], t["ramp"],
            t["tex"], t["edge"], hp // FG.TILE_H, wp // FG.TILE_W, cap,
            with_attrs=not outline))
    return parts


def random_frame_tables(seed: int, n_tris: tuple[int, ...], hp: int, wp: int,
                        device="cuda", pairs_per_tri: float = 4.0):
    """Frame-kernel tables (``frame_gpu.FrameTables``) for an
    (hp, wp) frame from :func:`random_pass_inputs`, packed with the
    engine's per-pass culling and pair capacity. The triangles span a fixed
    share of the frame, so a large frame needs a larger ``pairs_per_tri``
    than the engine's 4 to hold every pair (``overflow`` counts the rest)."""
    from .kernels import frame_gpu as FG

    parts = _random_pass_parts(seed, n_tris, hp, wp, device, pairs_per_tri)
    return FG.pack_frame_rows(parts, hp // FG.TILE_H, wp // FG.TILE_W)


def random_stream_tables(seed: int, n_tris: tuple[int, ...], hp: int, wp: int,
                         device="cuda"):
    """Stream-kernel tables (``frame_stream.StreamTables``) of the same
    pairs as :func:`random_frame_tables` with the same arguments."""
    from .kernels import frame_gpu as FG
    from .kernels import frame_stream as FS

    parts = _random_pass_parts(seed, n_tris, hp, wp, device)
    return FS.pack_stream(parts, hp // FG.TILE_H, wp // FG.TILE_W)


def random_raster_tables(seed: int, n_tris: tuple[int, ...], hp: int, wp: int,
                         device="cuda", cap: int | None = None):
    """Raster-pass tables (``raster_gpu.PassTables``), one per entry of
    ``n_tris``, from :func:`random_pass_inputs` with no culling. Each
    triangle's material id is its own index, so a G-buffer names the
    triangle that won each pixel. ``cap``: pair slots of each pass (default
    ``raster_gpu.pair_capacity``; the triangles span a fixed share of the
    frame, so a large frame needs more to hold every pair)."""
    import torch

    from .kernels import raster_gpu as RG
    from .render import raster

    out = []
    for d in random_pass_inputs(seed, n_tris):
        t = {k: torch.as_tensor(v, device=device) for k, v in d.items()}
        tri = raster.setup_triangles(t["corners_clip"], t["valid"], wp, hp, raster.CULL_NONE)
        out.append(RG.pack_tables(tri, t["corner_uv"], t["corner_nrm"],
                                  torch.arange(len(d["valid"]), device=device),
                                  hp // RG.TILE_H, wp // RG.TILE_W, cap))
    return out


def touched_bands(tables, wp: int):
    """The 8-row bands of a raster pass's 32x128 tiles that some pair's y
    range touches -> ((B, BANDS) bool, the number of (pair, band) pairs
    that touch)."""
    import torch

    from .kernels import raster_gpu as RG

    dev = tables.counts.device
    b_total, bx = tables.counts.shape[0], wp // RG.TILE_W
    n = int(tables.counts.sum())
    tile = torch.repeat_interleave(torch.arange(b_total, device=dev), tables.counts.long())
    ids = tables.ids[:n].long()
    y0 = (tile // bx * RG.TILE_H).float()
    b0, b1 = RG._band_range(tables.tab[ids, RG.C_YMIN], tables.tab[ids, RG.C_YMAX], y0)
    band = torch.arange(RG.BANDS, device=dev)
    hit = ((band >= b0[:, None]) & (band <= b1[:, None])).int()
    per_band = torch.zeros((b_total, RG.BANDS), dtype=torch.int32, device=dev)
    return per_band.index_add_(0, tile, hit) > 0, int(hit.sum())


def random_stack(seed: int, hp: int, wp: int, n_groups: int = 3,
                 empty_tiles=((0, 0),), device="cuda"):
    """A seeded planar two-layer stack (2*L_CH, hp, wp) for the stack
    shade: perspective-divided uv with per-tile gradients from 1/250 to 1/2
    texel-space units per pixel (so the mip LOD spans the levels), random
    normals, depths and group ids below ``n_groups``, a tenth outline
    fragments, a third empty pixels, and layer 0 empty in each 32x128 tile
    (row, column) of ``empty_tiles``."""
    import torch

    from .kernels import shade_gpu as SG

    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:hp, 0:wp].astype(np.float32) + 0.5
    by, bx = hp // SG.STACK_TILE_H, wp // SG.STACK_TILE_W
    layers = []
    for _ in range(2):
        st = np.zeros((SG.L_CH, hp, wp), np.float32)
        iw = rng.uniform(0.5, 2.0, (hp, wp))
        grad = rng.choice([0.004, 0.02, 0.1, 0.5], (by, bx)).repeat(
            SG.STACK_TILE_H, 0).repeat(SG.STACK_TILE_W, 1)
        u = xs * grad + rng.uniform(-1, 1) + 0.002 * rng.normal(size=(hp, wp))
        v = ys * grad * 0.7 + rng.uniform(-1, 1) + 0.002 * rng.normal(size=(hp, wp))
        nrm = rng.normal(size=(3, hp, wp))
        nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
        st[SG.L_UIW], st[SG.L_VIW] = u * iw, v * iw
        st[SG.L_NXIW:SG.L_NZIW + 1] = nrm * iw
        st[SG.L_IW] = iw
        st[SG.L_Z] = rng.uniform(0.05, 0.95, (hp, wp))
        st[SG.L_AEFF] = np.where(rng.random((hp, wp)) < 0.3, 0.0, rng.uniform(0, 1, (hp, wp)))
        st[SG.L_OUT] = rng.random((hp, wp)) < 0.1
        for ch in (SG.L_RAMP, SG.L_TEX, SG.L_EDGE):
            st[ch] = rng.integers(0, n_groups, (hp, wp))
        layers.append(st)
    for ti, tj in empty_tiles:
        layers[0][SG.L_AEFF, ti * SG.STACK_TILE_H:(ti + 1) * SG.STACK_TILE_H,
                  tj * SG.STACK_TILE_W:(tj + 1) * SG.STACK_TILE_W] = 0.0
    return torch.as_tensor(np.concatenate(layers), device=device)


def decoded_index(o, layer: int) -> np.ndarray:
    """Nearest texel index per pixel of a (2*O_CH, hp, wp) shade output,
    decoded the way the composite does; -1 where the layer is untextured."""
    from .kernels import shade_gpu as SG

    o = np.asarray(o)
    b = layer * SG.O_CH
    dxdy = o[b + SG.O_DXDY]
    dx = np.fmod(dxdy, 2.0)
    dy = (dxdy - dx) * 0.5
    near = (o[b + SG.O_TEX] + np.where(o[b + SG.O_FX] > 0.5, dx, 0.0)
            + np.where(o[b + SG.O_FY] > 0.5, dy, 0.0))
    return np.where(o[b + SG.O_TEX] >= 0, np.maximum(near, 0).astype(np.int64), -1)


# bounds of a shade-output comparison (frame kernel against its twin or
# the Pallas reference): decoded texel index, a_eff (within AEFF_TOL) and
# the footprint step agree on at least SAME_FRAC of each layer's pixels,
# and lit rgb + rim agree within LIT_TOL on those pixels
SAME_FRAC = 0.995
AEFF_TOL = 1e-5
LIT_TOL = 1e-4
# of a raster-pass comparison: depths lie in [0, 1], so a few float32
# ulps; z and attributes where the winner agrees, as rtol and atol
Z_TOL = 1e-6
RASTER_TOL = 1e-5


def bit_diff(got, want) -> tuple[float, float]:
    """Two float32 tensors of one shape -> (fraction of values equal by
    value or bit for bit, largest absolute difference of the others; inf
    where one is not a number). Bit equality covers the stream kernel's
    winner keys, int32 bits that may read as NaN."""
    import torch

    same = (got == want) | (got.view(torch.int32) == want.view(torch.int32))
    d = torch.nan_to_num((got - want).abs(), nan=float("inf"))
    d = torch.where(same, 0.0, d)
    # counted as integers: a float32 mean of 3e8 ones is not exactly 1
    return int(same.sum()) / max(same.numel(), 1), (d.max().item() if d.numel() else 0.0)


def compare_raster(z_test, g_test, z_ref, g_ref) -> dict:
    """Raster-pass outputs (depth buffer (S, hp, wp), G-buffer (N_CH, hp,
    wp)) against a reference: material id and cover equal on at least
    SAME_FRAC of pixels, depths within Z_TOL on SAME_FRAC of samples, and
    where the material id agrees and is >= 0, the centre z and the six
    attribute planes within RASTER_TOL (rtol and atol). -> {"fracs": [mat,
    cover, depth], "drawn_err": the largest of those z/attribute
    differences, "max_abs_err" and "equal_frac" over every channel and
    depth, "ok"}."""
    from .kernels import raster_gpu as RG

    mat_same = g_test[RG.CH_MAT] == g_ref[RG.CH_MAT]
    fracs = [mat_same.float().mean().item(),
             (g_test[RG.CH_COVER] == g_ref[RG.CH_COVER]).float().mean().item(),
             ((z_test - z_ref).abs() <= Z_TOL).float().mean().item()]
    chans = [*range(RG.CH_UIW, RG.CH_IW + 1), RG.CH_Z]
    drawn = mat_same & (g_ref[RG.CH_MAT] >= 0)
    d = (g_test[chans] - g_ref[chans]).abs()[:, drawn]
    excess = d - RASTER_TOL * (1 + g_ref[chans].abs()[:, drawn])
    return {"fracs": fracs, "drawn_err": d.max().item() if d.numel() else 0.0,
            "max_abs_err": max((g_test - g_ref).abs().max().item(),
                               (z_test - z_ref).abs().max().item()),
            "equal_frac": min((g_test == g_ref).float().mean().item(),
                              (z_test == z_ref).float().mean().item()),
            "ok": min(fracs) >= SAME_FRAC and not (excess > 0).any().item()}


def compare_shade(o_test, o_ref) -> dict:
    """-> {"same_frac": worst layer's agreeing fraction, "max_abs_err":
    largest lit/rim difference on agreeing pixels, "ok": within bounds,
    "same": per-layer boolean masks}."""
    from .kernels import shade_gpu as SG

    o_test, o_ref = np.asarray(o_test), np.asarray(o_ref)
    fracs, errs, masks = [], [0.0], []
    for layer in range(2):
        b = layer * SG.O_CH
        same = ((decoded_index(o_test, layer) == decoded_index(o_ref, layer))
                & (np.abs(o_test[b + SG.O_AEFF] - o_ref[b + SG.O_AEFF]) <= AEFF_TOL)
                & (o_test[b + SG.O_DXDY] == o_ref[b + SG.O_DXDY]))
        fracs.append(float(same.mean()))
        masks.append(same)
        for ch in (SG.O_LR, SG.O_LG, SG.O_LB, SG.O_RIM):
            d = np.abs(o_test[b + ch] - o_ref[b + ch])[same]
            errs.append(float(d.max()) if d.size else 0.0)
    return {"same_frac": min(fracs), "max_abs_err": max(errs),
            "ok": min(fracs) >= SAME_FRAC and max(errs) <= LIT_TOL, "same": masks}


# ---------------------------------------------------------------------------
# PMX, VMD and texture writers
# ---------------------------------------------------------------------------


class _Out:
    """Little-endian byte assembly for the writers."""

    def __init__(self, encoding: str = "utf-16-le"):
        self.parts: list[bytes] = []
        self.encoding = encoding

    def raw(self, b: bytes) -> None:
        self.parts.append(bytes(b))

    def pack(self, fmt: str, *values) -> None:
        self.parts.append(struct.pack("<" + fmt, *values))

    def floats(self, values) -> None:
        self.parts.append(np.asarray(values, "<f4").tobytes())

    def text(self, s: str) -> None:
        b = s.encode(self.encoding)
        self.pack("i", len(b))
        self.raw(b)

    def index(self, size: int, value: int, vertex: bool = False) -> None:
        self.pack({1: "B" if vertex else "b", 2: "H" if vertex else "h", 4: "i"}[size],
                  int(value))

    def data(self) -> bytes:
        return b"".join(self.parts)


def _index_size(count: int, vertex: bool, forced: int | None) -> int:
    """The least index size for ``count`` items (vertex indices unsigned at
    1 and 2 bytes, every other index signed), or ``forced`` if it fits."""
    fits = {1: count <= (256 if vertex else 128), 2: count <= (65536 if vertex else 32768),
            4: True}
    if forced is not None:
        if not fits[forced]:
            raise ValueError(f"{count} items do not fit {forced}-byte indices")
        return forced
    return next(s for s in (1, 2, 4) if fits[s])


def write_pmx(path: str, model: PMXModel, encoding: str = "utf-16-le",
              index_size: int | None = None) -> None:
    """Write ``model`` as a PMX file: text in ``encoding`` ("utf-16-le" or
    "utf-8"), every index ``index_size`` bytes (1, 2 or 4; None: the least
    that fits each kind). Morphs of kinds 9 (flip) and 10 (impulse), which
    the parser reads past, take their records from a ``flip`` attribute
    ((morph indices, ratios)) or an ``impulse`` attribute ((body indices,
    local flags, velocities (n, 3), torques (n, 3))) of the morph."""
    o = _Out(encoding)
    n_add = 0 if model.additional_uvs is None else model.additional_uvs.shape[1]
    v = model.positions.shape[0]
    v_sz = _index_size(v, True, index_size)
    tex_sz = _index_size(len(model.textures), False, index_size)
    mat_sz = _index_size(len(model.materials), False, index_size)
    bone_sz = _index_size(len(model.bones), False, index_size)
    morph_sz = _index_size(len(model.morphs), False, index_size)
    rb_sz = _index_size(len(model.rigid_bodies), False, index_size)
    o.raw(b"PMX ")
    o.pack("f", model.version)
    o.pack("9B", 8, 0 if encoding == "utf-16-le" else 1, n_add, v_sz, tex_sz, mat_sz,
           bone_sz, morph_sz, rb_sz)
    for s in (model.name, model.english_name, model.comment, model.english_comment):
        o.text(s)

    o.pack("i", v)
    for i in range(v):
        o.floats(model.positions[i])
        o.floats(model.normals[i])
        o.floats(model.uvs[i])
        if n_add:
            o.floats(model.additional_uvs[i].reshape(-1))
        dt = int(model.deform_types[i])
        o.pack("B", dt)
        j, w = model.joints4[i], model.weights4[i]
        if dt == DEFORM_BDEF1:
            o.index(bone_sz, j[0])
        elif dt in (DEFORM_BDEF2, DEFORM_SDEF):
            o.index(bone_sz, j[0])
            o.index(bone_sz, j[1])
            o.floats(w[:1])
            if dt == DEFORM_SDEF:
                o.floats(model.sdef_c[i])
                o.floats(model.sdef_r0[i])
                o.floats(model.sdef_r1[i])
        else:  # BDEF4, QDEF, or a type the parser refuses (its four-index layout)
            for k in range(4):
                o.index(bone_sz, j[k])
            o.floats(w)
        o.floats(model.edge_scale[i:i + 1])

    o.pack("i", model.indices.size)
    o.raw(model.indices.astype({1: "<u1", 2: "<u2", 4: "<i4"}[v_sz]).tobytes())
    o.pack("i", len(model.textures))
    for t in model.textures:
        o.text(t)

    o.pack("i", len(model.materials))
    for m in model.materials:
        o.text(m.name)
        o.text(m.english_name)
        o.floats(m.diffuse)
        o.floats(m.specular)
        o.floats([m.shininess])
        o.floats(m.ambient)
        o.pack("B", m.flags)
        o.floats(m.edge_color)
        o.floats([m.edge_size])
        o.index(tex_sz, m.texture_index)
        o.index(tex_sz, m.sphere_texture_index)
        o.pack("BB", m.sphere_mode, 1 if m.shared_toon else 0)
        if m.shared_toon:
            o.pack("B", m.toon_texture_index)
        else:
            o.index(tex_sz, m.toon_texture_index)
        o.text(m.comment)
        o.pack("i", m.index_count)

    o.pack("i", len(model.bones))
    for b in model.bones:
        o.text(b.name)
        o.text(b.english_name)
        o.floats(b.position)
        o.index(bone_sz, b.parent)
        o.pack("iH", b.transform_order, b.flags)
        if b.flags & FLAG_TAIL_IS_BONE:
            o.index(bone_sz, b.tail_bone)
        else:
            o.floats(b.tail_offset if b.tail_offset is not None else np.zeros(3))
        if b.flags & (FLAG_APPEND_ROTATE | FLAG_APPEND_MOVE):
            o.index(bone_sz, b.append_parent)
            o.floats([b.append_ratio])
        if b.flags & FLAG_AXIS_LIMIT:
            o.floats(b.axis_limit)
        if b.flags & FLAG_LOCAL_AXIS:
            o.floats(b.local_axis_x)
            o.floats(b.local_axis_z)
        if b.flags & FLAG_EXTERNAL_PARENT:
            o.pack("i", b.external_parent)
        if b.flags & FLAG_IK:
            o.index(bone_sz, b.ik.target)
            o.pack("i", b.ik.loop_count)
            o.floats([b.ik.limit_angle])
            o.pack("i", len(b.ik.links))
            for link in b.ik.links:
                o.index(bone_sz, link.bone)
                o.pack("B", 1 if link.has_limit else 0)
                if link.has_limit:
                    o.floats(link.limit_min)
                    o.floats(link.limit_max)

    o.pack("i", len(model.morphs))
    for mo in model.morphs:
        o.text(mo.name)
        o.text(mo.english_name)
        o.pack("BB", mo.panel, mo.kind)
        if mo.kind == 0:
            rows = list(zip(mo.group_indices, mo.group_ratios))
            o.pack("i", len(rows))
            for gi, gr in rows:
                o.index(morph_sz, gi)
                o.floats([gr])
        elif mo.kind == 1:
            o.pack("i", len(mo.vertex_indices))
            for vi, off in zip(mo.vertex_indices, mo.vertex_offsets):
                o.index(v_sz, vi, vertex=True)
                o.floats(off)
        elif mo.kind == 2:
            o.pack("i", len(mo.bone_indices))
            for bi, bt, br in zip(mo.bone_indices, mo.bone_translations, mo.bone_rotations):
                o.index(bone_sz, bi)
                o.floats(bt)
                o.floats(br)
        elif mo.kind in (3, 4, 5, 6, 7):
            o.pack("i", len(mo.uv_indices))
            for ui, off in zip(mo.uv_indices, mo.uv_offsets):
                o.index(v_sz, ui, vertex=True)
                o.floats(off)
        elif mo.kind == 8:
            o.pack("i", len(mo.mat_indices))
            for mi, op, dat in zip(mo.mat_indices, mo.mat_ops, mo.mat_data):
                o.index(mat_sz, mi)
                o.pack("B", op)
                o.floats(dat)
        elif mo.kind == 9:
            idx, ratios = mo.flip
            o.pack("i", len(idx))
            for mi, r in zip(idx, ratios):
                o.index(morph_sz, mi)
                o.floats([r])
        elif mo.kind == 10:
            bodies, local, vel, torque = mo.impulse
            o.pack("i", len(bodies))
            for k in range(len(bodies)):
                o.index(rb_sz, bodies[k])
                o.pack("B", local[k])
                o.floats(vel[k])
                o.floats(torque[k])
        else:
            raise ValueError(f"morph kind {mo.kind}")

    # display frames: the root bone, and the first morphs
    o.pack("i", 2)
    o.text("Root")
    o.text("Root")
    o.pack("Bi", 1, 1)
    o.pack("B", 0)
    o.index(bone_sz, 0)
    o.text("表情")
    o.text("Exp")
    n_exp = min(len(model.morphs), 4)
    o.pack("Bi", 0, n_exp)
    for k in range(n_exp):
        o.pack("B", 1)
        o.index(morph_sz, k)

    o.pack("i", len(model.rigid_bodies))
    for rb in model.rigid_bodies:
        o.text(rb.name)
        o.text(rb.english_name)
        o.index(bone_sz, rb.bone)
        o.pack("BHB", rb.group, rb.collision_mask, rb.shape)
        o.floats(rb.size)
        o.floats(rb.position)
        o.floats(rb.rotation)
        o.floats([rb.mass, rb.linear_damping, rb.angular_damping, rb.restitution,
                  rb.friction])
        o.pack("B", rb.mode)

    o.pack("i", len(model.joints))
    for jt in model.joints:
        o.text(jt.name)
        o.text(jt.english_name)
        o.pack("B", jt.kind)
        o.index(rb_sz, jt.body_a)
        o.index(rb_sz, jt.body_b)
        for a in (jt.position, jt.rotation, jt.position_min, jt.position_max,
                  jt.rotation_min, jt.rotation_max, jt.spring_position, jt.spring_rotation):
            o.floats(a)
    with open(path, "wb") as f:
        f.write(o.data())


def _sjis(name: str, size: int) -> bytes:
    """A name as Shift-JIS cut to ``size`` bytes (possibly inside a
    character, as MMD cuts it) and padded with zeros."""
    return name.encode("shift_jis")[:size].ljust(size, b"\0")


def write_vmd(path: str, motion: VMDMotion) -> None:
    """Write ``motion`` as a VMD file: its bone, morph and camera keys
    (names cut to 15 bytes, the model name to 20), no light or shadow keys."""
    o = _Out()
    o.raw(b"Vocaloid Motion Data 0002".ljust(30, b"\0"))
    o.raw(_sjis(motion.model_name, 20))
    n = len(motion.bone_names)
    o.pack("I", n)
    q = np.clip(np.rint(np.asarray(motion.bone_interp, np.float64) * 127.0), 0, 127)
    for i in range(n):
        o.raw(_sjis(motion.bone_names[i], 15))
        o.pack("I", int(motion.bone_frames[i]))
        o.floats(motion.bone_positions[i])
        o.floats(motion.bone_rotations[i])
        # byte 4k + c holds the k-th control value (x1, y1, x2, y2) of
        # channel c (X, Y, Z, R); the other 48 bytes repeat it shifted
        row = q[i].T.reshape(-1).astype(np.uint8).tobytes()
        o.raw(b"".join(row[r:] + bytes(r) for r in range(4)))
    o.pack("I", len(motion.morph_names))
    for name, frame, w in zip(motion.morph_names, motion.morph_frames, motion.morph_weights):
        o.raw(_sjis(name, 15))
        o.pack("I", int(frame))
        o.floats([w])
    o.pack("I", motion.camera_frames.shape[0])
    for i in range(motion.camera_frames.shape[0]):
        o.pack("I", int(motion.camera_frames[i]))
        o.floats([motion.camera_distance[i]])
        o.floats(motion.camera_position[i])
        o.floats(motion.camera_rotation[i])
        o.raw(bytes([20, 107, 20, 107] * 6))
        o.pack("IB", int(motion.camera_fov[i]), 0)
    o.pack("II", 0, 0)  # light and self-shadow keys
    with open(path, "wb") as f:
        f.write(o.data())


def write_bmp(path: str, img: np.ndarray, palette=None, top_down: bool = False,
              bitfields: bool = False) -> None:
    """Write an uncompressed BMP: (h, w, 3) as 24-bit, (h, w, 4) as 32-bit
    (with ``bitfields`` a version-4 header with BGRA masks, so the fourth
    byte is alpha), or (h, w) palette indices with ``palette`` ((n, 3)
    uint8) as 8-bit; rows bottom-up, or top-down with ``top_down``."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if palette is not None:
        bits, px = 8, img[..., None]
        table = np.zeros((len(palette), 4), np.uint8)
        table[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
        table = table.tobytes()
    else:
        bits = 8 * img.shape[2]
        px = np.concatenate([img[..., 2::-1], img[..., 3:]], -1)
        table = b""
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bits // 8] = px.reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    hsize = 108 if bitfields else 40
    offset = 14 + hsize + len(table)
    info = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1, bits,
                       3 if bitfields else 0, rows.size, 2835, 2835,
                       len(palette) if palette is not None else 0, 0)
    if bitfields:
        info += struct.pack("<4I", 0xFF0000, 0xFF00, 0xFF, 0xFF000000) + bytes(hsize - 56)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", offset + rows.size, 0, 0, offset)
                + info + table + rows.tobytes())


def write_tga(path: str, img: np.ndarray, rle: bool = False, top: bool = False,
              right_to_left: bool = False) -> None:
    """Write a true-colour TGA: (h, w, 3) as 24-bit, (h, w, 4) as 32-bit;
    image type 10 (run-length) with ``rle``, else 2; rows bottom-up unless
    ``top``, columns right to left with ``right_to_left``."""
    img = np.asarray(img, np.uint8)
    h, w, c = img.shape
    px = np.concatenate([img[..., 2::-1], img[..., 3:]], -1)
    if not top:
        px = px[::-1]
    if right_to_left:
        px = px[:, ::-1]
    flat = px.reshape(-1, c)
    if rle:  # runs of equal pixels, and raw packets between them
        out, i, n = bytearray(), 0, flat.shape[0]
        while i < n:
            j = i + 1
            while j < n and j - i < 128 and (flat[j] == flat[i]).all():
                j += 1
            if j - i > 1:
                out.append(0x80 | (j - i - 1))
                out += flat[i].tobytes()
            else:
                while j < n and j - i < 128 and not (flat[j] == flat[j - 1]).all():
                    j += 1
                out.append(j - i - 1)
                out += flat[i:j].tobytes()
            i = j
        data = bytes(out)
    else:
        data = flat.tobytes()
    flags = (8 if c == 4 else 0) | (0x20 if top else 0) | (0x10 if right_to_left else 0)
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 10 if rle else 2, 0, 0, 0, 0, 0, w, h,
                       8 * c, flags)
    with open(path, "wb") as f:
        f.write(head + data)


# ---------------------------------------------------------------------------
# A seeded PMX model, its textures and a clip
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PMXSpec:
    """A model to write: the PMX (``formats.pmx.PMXModel``), its textures
    (file name -> (h, w, c) uint8 image, written by the name's extension)
    and a clip for it (``formats.vmd.VMDMotion``)."""

    model: PMXModel
    textures: dict
    motion: VMDMotion


# the flagship's widths, as tests/test_formats.py records them
FLAGSHIP = dict(vertices=28842, bones=349, morphs=72, bodies=257, joints=406)
_HAIR_CHAINS, _SKIRT_ROWS, _SKIRT_COLS = 33, 8, 15
# (name, part, triangles, texture, edge flag) per material, in file order;
# the eye, hair and transparent materials sum to the flagship's class
# split (928, 1,347 and 4,875 triangles), the opaque ones to 26,583
_FLAGSHIP_MATERIALS = (
    ("face", "face", 3000, "face.png", False), ("目白", "eye_white", 42, "face.png", False),
    ("右瞳", "eye_r", 140, "face.png", False), ("左瞳", "eye_l", 140, "face.png", False),
    ("eyebrow", "brow", 170, "face.png", False), ("eyelash", "lash", 436, "face.png", False),
    ("hair_f", "hair_front", 1347, "hair.png", True),
    ("hair_b", "hair_back", 4200, "hair.png", True),
    ("body", "torso", 4400, "body.png", True), ("arm", "arms", 2600, "body.png", True),
    ("hand", "hands", 3000, "body.png", False), ("leg", "legs", 3200, "body.png", True),
    ("shoes", "shoes", 1400, "body.png", True), ("skirt", "skirt", 3400, "dress.png", True),
    ("dress", "dress", 3315, "dress.png", True), ("veil", "sleeves", 1560, "dress.png", False),
    ("ribbon", "ribbon", 700, "dress.png", True), ("neck", "neck", 400, "body.png", False),
    ("brooch", "brooch", 283, "dress.png", False),
)
_SMALL_MATERIALS = (
    ("face", "face", 40, "face.png", False), ("目白", "eye_white", 6, "face.png", False),
    ("hair_f", "hair_front", 40, "hair.png", True), ("body", "torso", 40, "body.png", True),
    ("leg", "legs", 40, "body.png", True), ("dress", "dress", 40, "dress.png", True),
    ("arm", "arms", 40, "body.png", False),
)
_ALPHA = {"dress": 0.85, "veil": 0.6}
_TOON = "toon.bmp"
_HEAD = np.array([0.0, 17.6, 0.0])
# (latitude, longitude) windows of the eye materials on the head sphere,
# and their radius
_EYES = {"eye_white": ((0.02, 0.26), (-0.6, 0.6), 1.52),
         "eye_r": ((0.06, 0.22), (-0.48, -0.18), 1.54),
         "eye_l": ((0.06, 0.22), (0.18, 0.48), 1.54),
         "brow": ((0.34, 0.46), (-0.6, 0.6), 1.53),
         "lash": ((0.27, 0.31), (-0.6, 0.6), 1.535)}


def _bone(name, position, parent, flags=0x1A, **kw) -> PMXBone:
    """A rotatable, visible, enabled bone (flags 0x1A) with a tail offset."""
    b = PMXBone(name, "", np.asarray(position, np.float32), parent, 0, flags,
                tail_offset=np.zeros(3, np.float32))
    for k, v in kw.items():
        setattr(b, k, v)
    return b


def _skeleton(flagship: bool) -> tuple[list, dict]:
    """The humanoid's bones and their indices by name: root, centre, spine,
    neck and head, arms, legs with leg IK (40 loops, 2 links, a knee
    limit), and append bones (a wrist twist; the flagship's eyes, arm
    twists and D legs). The flagship has both sides, shoulders, toe IK and
    fingers; the small model one side and a bone of every optional record
    (tail bone, axis limit, local axes, external parent, append move)."""
    bones, at = [], {}

    def add(name, pos, parent, **kw):
        at[name] = len(bones)
        bones.append(_bone(name, pos, at[parent] if parent else -1, **kw))

    def append(name, src, ratio, move=False):
        b = bones[at[name]]
        b.flags |= FLAG_APPEND_ROTATE | (FLAG_APPEND_MOVE if move else 0)
        b.append_parent, b.append_ratio = at[src], ratio

    zero3 = np.zeros(3, np.float32)
    add("全ての親", (0, 0, 0), None, flags=0x1E)
    add("センター", (0, 8, 0), "全ての親", flags=0x1E)
    add("下半身", (0, 10.8, 0), "センター")
    add("上半身", (0, 11.2, 0), "センター")
    spine = "上半身"
    if flagship:
        add("上半身2", (0, 13, 0), "上半身")
        spine = "上半身2"
    add("首", (0, 15.8, 0), spine)
    add("頭", (0, 16.6, 0), "首")
    if flagship:
        add("両目", (0, 17.8, -1.2), "頭")
        for side, s in (("左", 1.0), ("右", -1.0)):
            add(f"{side}目", (0.55 * s, 17.8, -1.2), "頭")
            append(f"{side}目", "両目", 1.0)
    for side, s in ((("左", 1.0), ("右", -1.0)) if flagship else (("左", 1.0),)):
        shoulder = spine
        if flagship:
            add(f"{side}肩", (0.6 * s, 15.4, 0), spine)
            shoulder = f"{side}肩"
        add(f"{side}腕", (1.6 * s, 15.2, 0), shoulder)
        elbow_parent = f"{side}腕"
        if flagship:
            add(f"{side}腕捩", (2.9 * s, 14.2, 0), f"{side}腕")
            append(f"{side}腕捩", f"{side}腕", 0.5)
            elbow_parent = f"{side}腕捩"
        add(f"{side}ひじ", (4.2 * s, 13.2, 0), elbow_parent)
        add(f"{side}手首", (6.2 * s, 11.6, 0), f"{side}ひじ")
        append(f"{side}手首", f"{side}ひじ", 0.5)
        add(f"{side}足", (1.0 * s, 10.4, 0), "下半身")
        add(f"{side}ひざ", (1.0 * s, 5.8, -0.5), f"{side}足")  # a bent knee
        add(f"{side}足首", (1.0 * s, 1.2, 0.1), f"{side}ひざ")
        knee = PMXIKLink(at[f"{side}ひざ"], True, np.array([-np.pi, 0, 0], np.float32),
                         np.array([-0.008727, 0, 0], np.float32))
        thigh = PMXIKLink(at[f"{side}足"], False, zero3, zero3)
        add(f"{side}足ＩＫ", (1.0 * s, 1.2, 0.1), "全ての親", flags=0x3E,
            ik=PMXIK(at[f"{side}足首"], 40, 2.0, [knee, thigh]))
        if flagship:
            add(f"{side}つま先", (1.0 * s, 0.1, -1.3), f"{side}足首")
            add(f"{side}つま先ＩＫ", (1.0 * s, 0.1, -1.3), f"{side}足ＩＫ", flags=0x3E,
                ik=PMXIK(at[f"{side}つま先"], 3, 4.0,
                         [PMXIKLink(at[f"{side}足首"], False, zero3, zero3)]))
            parent = "下半身"
            for leg in ("足", "ひざ", "足首"):
                add(f"{side}{leg}D", bones[at[f"{side}{leg}"]].position, parent)
                append(f"{side}{leg}D", f"{side}{leg}", 1.0)
                parent = f"{side}{leg}D"
            for f, finger in enumerate(("親指", "人指", "中指", "薬指", "小指")):
                parent = f"{side}手首"
                for k in range(3):
                    name = f"{side}{finger}{k + 1}"
                    add(name, ((6.7 + 0.45 * k) * s, 11.3 - 0.3 * k, -0.4 + 0.2 * f), parent)
                    parent = name
    if not flagship:
        add("右目", (-0.55, 17.8, -1.2), "頭",
            flags=0x1A | FLAG_TAIL_IS_BONE | FLAG_AXIS_LIMIT | FLAG_LOCAL_AXIS
            | FLAG_EXTERNAL_PARENT, tail_bone=at["頭"], tail_offset=None,
            axis_limit=np.array([0, 1, 0], np.float32),
            local_axis_x=np.array([1, 0, 0], np.float32),
            local_axis_z=np.array([0, 0, 1], np.float32), external_parent=0)
        append("右目", "頭", 0.3, move=True)
    return bones, at


def _physics(rng, bones: list, at: dict, flagship: bool) -> tuple[list, list]:
    """Rigid bodies and joints, with a bone for each hair and skirt body.

    Small: a sphere on the head, a capsule and a box hung from it, two
    joints. Flagship (257 bodies, 406 joints): kinematic anchors (head,
    chest, hips, legs), 33 hair chains of four capsules down the back of
    the head, an 8 x 15 skirt of thin boxes around the hips, joints along
    chains, columns and rings, and links between neighbouring hair chains.
    Hair collides with the head, chest and hips, the skirt with the legs,
    nothing with its own kind."""
    bodies, joints = [], []

    def body(name, bone, shape, size, pos, rot=(0, 0, 0), mode=1, group=0, mask=0):
        bodies.append(PMXRigidBody(
            name, "", bone, group, mask, shape, np.asarray(size, np.float32),
            np.asarray(pos, np.float32), np.asarray(rot, np.float32),
            float(rng.uniform(0.5, 1.5)), float(rng.uniform(0.5, 0.9)),
            float(rng.uniform(0.8, 0.99)), 0.0, 0.5, mode))
        return len(bodies) - 1

    def joint(a, b, pos, ang, lin=0.0, k_ang=0.0, k_lin=0.0):
        ang = np.asarray(ang, np.float32)
        joints.append(PMXJoint(
            f"J{len(joints)}", "", 0, a, b, np.asarray(pos, np.float32),
            np.zeros(3, np.float32), np.full(3, -lin, np.float32), np.full(3, lin, np.float32),
            -ang, ang, np.full(3, k_lin, np.float32), np.full(3, k_ang, np.float32)))

    def chain_bone(name, pos, parent) -> int:
        at[name] = len(bones)
        bones.append(_bone(name, pos, parent))
        return at[name]

    if not flagship:
        head = body("頭", at["頭"], 0, (1.5, 0, 0), _HEAD, mode=0)
        b1 = chain_bone("髪1", (0, 17.0, 1.6), at["頭"])
        b2 = chain_bone("髪2", (0, 15.0, 1.9), b1)
        h1 = body("髪1", b1, 2, (0.3, 1.2, 0), (0, 16.0, 1.7), (0.2, 0, 0), group=1)
        h2 = body("髪2", b2, 1, (0.4, 0.6, 0.15), (0, 14.2, 1.9), group=1)
        joint(head, h1, (0, 17.0, 1.6), (0.5, 0.5, 0.5), k_ang=5.0)
        joint(h1, h2, (0, 15.0, 1.9), (0.6, 0.2, 0.6), lin=0.1, k_lin=20.0)
        return bodies, joints

    head = body("頭", at["頭"], 0, (1.6, 0, 0), _HEAD, mode=0, mask=0b10)
    body("胸", at["上半身2"], 0, (1.5, 0, 0), (0, 13.5, 0), mode=0, mask=0b10)
    hips = body("腰", at["下半身"], 1, (1.5, 0.6, 1.0), (0, 10.2, 0), mode=0, mask=0b10)
    for side, s in (("左", 1.0), ("右", -1.0)):
        body(f"{side}足", at[f"{side}足"], 2, (0.8, 4.0, 0), (s, 8.1, 0), mode=0, group=4,
             mask=0b100)
    level_of = {}
    for c in range(_HAIR_CHAINS):
        out = _hair_out(c / (_HAIR_CHAINS - 1))
        for lvl in range(4):
            top = _hair_point(out, lvl / 4)
            bone = chain_bone(f"髪{c}_{lvl}", top, at["頭"] if lvl == 0 else bodies[-1].bone)
            parent = head if lvl == 0 else level_of[(c, lvl - 1)]
            level_of[(c, lvl)] = body(
                f"髪{c}_{lvl}", bone, 2, (0.12, 0.9, 0), _hair_point(out, (lvl + 0.5) / 4),
                mode=2 if (lvl == 0 and c % 8 == 0) else 1, group=1, mask=0b1)
            joint(parent, level_of[(c, lvl)], top, (0.6, 0.6, 0.6),
                  k_ang=20.0 if c % 2 == 0 else 0.0)
    first = len(bodies)
    for r in range(_SKIRT_ROWS):
        for c in range(_SKIRT_COLS):
            pos = _skirt_point(c / _SKIRT_COLS, (r + 0.5) / _SKIRT_ROWS, 0.0)
            top = _skirt_point(c / _SKIRT_COLS, r / _SKIRT_ROWS, 0.0)
            parent = hips if r == 0 else len(bodies) - _SKIRT_COLS
            bone = chain_bone(f"スカート{r}_{c}", top,
                              at["下半身"] if r == 0 else bodies[parent].bone)
            body(f"スカート{r}_{c}", bone, 1, (0.45, 0.4, 0.06), pos,
                 (0.3, np.pi / 2 - 2 * np.pi * c / _SKIRT_COLS, 0), group=2, mask=0b10000)
            joint(parent, len(bodies) - 1, top, (0.5, 0.05, 0.3), k_ang=10.0)
    for r in range(_SKIRT_ROWS):
        for c in range(_SKIRT_COLS):
            a, b = first + r * _SKIRT_COLS + c, first + r * _SKIRT_COLS + (c + 1) % _SKIRT_COLS
            joint(a, b, (bodies[a].position + bodies[b].position) / 2, (1.0, 1.0, 1.0),
                  lin=0.3, k_lin=50.0)
    links = [(c, lvl) for lvl in range(1, 4) for c in range(_HAIR_CHAINS - 1)]
    for c, lvl in links[:FLAGSHIP["joints"] - len(joints)]:
        a, b = level_of[(c, lvl)], level_of[(c + 1, lvl)]
        joint(a, b, (bodies[a].position + bodies[b].position) / 2, (1.0, 1.0, 1.0),
              lin=0.3, k_lin=50.0)
    return bodies, joints


def _hair_out(s):
    """The outward direction of hair at ``s`` in [0, 1] across the back of
    the head (+z is the back)."""
    th = np.pi * (0.25 + 0.5 * np.asarray(s, np.float64))
    return np.stack([np.cos(th), np.zeros_like(th), np.sin(th)], -1)


def _hair_point(out, t, lift=0.0):
    """A point ``t`` in [0, 1] down a hair strand leaving the head along
    ``out``: hair hangs down the back, clear of the arms."""
    t = np.asarray(t, np.float64)[..., None]
    return _HEAD + (1.9 + 0.5 * t + lift) * out - np.array([0.0, 5.5, 0.0]) * t


def _skirt_point(s, t, lift):
    """A point of the skirt at ``s`` around (from +x) and ``t`` down, in [0, 1]."""
    s, t = np.asarray(s, np.float64), np.asarray(t, np.float64)
    rad = 2.0 + 2.4 * t + lift
    return np.stack([rad * np.cos(2 * np.pi * s), 10.0 - 6.4 * t, rad * np.sin(2 * np.pi * s)], -1)


def _surface(part: str, side: int, u, v, at: dict, bones: list):
    """A material's surface on an (R, C) grid of (u around, v along) ->
    (points, outward normals, the two bones that carry each vertex and the
    first one's weight), for ``side`` 0 (left) or 1 (right) of a limb."""
    bpos = lambda name: bones[at[name]].position.astype(np.float64)  # noqa: E731
    full = lambda name: np.full(u.shape, at[name])  # noqa: E731
    sd, s = ("左", 1.0) if side == 0 else ("右", -1.0)
    spine = "上半身2" if "上半身2" in at else "上半身"

    def tube(a, b, r0, r1, bone_a, bone_b):
        d = (b - a) / np.linalg.norm(b - a)
        e1 = np.cross(d, [0.0, 0.0, 1.0])
        e1 = e1 / np.linalg.norm(e1) if np.linalg.norm(e1) > 1e-6 else np.array([1.0, 0, 0])
        e2 = np.cross(d, e1)
        tau = 2 * np.pi * u[..., None]
        out = np.cos(tau) * e1 + np.sin(tau) * e2
        p = a + v[..., None] * (b - a) + (r0 + (r1 - r0) * v[..., None]) * out
        return p, out, full(bone_a), full(bone_b), 1.0 - v

    def shell(center, radius, lat, lon, bone):
        la = lat[0] + (lat[1] - lat[0]) * v
        lo = lon[0] + (lon[1] - lon[0]) * u
        out = np.stack([np.cos(la) * np.sin(lo), np.sin(la), -np.cos(la) * np.cos(lo)], -1)
        return center + radius * out, out, full(bone), full(bone), np.ones_like(u)

    if part == "face":
        return shell(_HEAD, 1.5, (-1.2, 1.2), (-1.4, 1.4), "頭")
    if part in _EYES:
        lat, lon, r = _EYES[part]
        return shell(_HEAD, r, lat, lon, "頭")
    if part == "hair_front":
        return shell(_HEAD, 1.75, (0.15, 1.45), (-np.pi, np.pi), "頭")
    if part == "hair_back":  # strands over the hair chains' bones
        out = _hair_out(u)
        p = _hair_point(out, v, lift=0.15)
        chain = np.rint(u * (_HAIR_CHAINS - 1)).astype(int)
        lvl = np.minimum(np.floor(v * 4), 3).astype(int)
        lvl1 = np.minimum(lvl + 1, 3)
        ja = np.vectorize(lambda c, k: at[f"髪{c}_{k}"])(chain, lvl)
        jb = np.vectorize(lambda c, k: at[f"髪{c}_{k}"])(chain, lvl1)
        return p, out, ja, jb, 1.0 - np.clip(v * 4 - lvl, 0.0, 1.0)
    if part == "skirt":
        p = _skirt_point(u, v, 0.12)
        out = np.stack([np.cos(2 * np.pi * u), np.full(u.shape, 0.35), np.sin(2 * np.pi * u)], -1)
        col = np.rint(u * _SKIRT_COLS).astype(int) % _SKIRT_COLS
        row = np.minimum(np.floor(v * _SKIRT_ROWS), _SKIRT_ROWS - 1).astype(int)
        row1 = np.minimum(row + 1, _SKIRT_ROWS - 1)
        ja = np.vectorize(lambda r, c: at[f"スカート{r}_{c}"])(row, col)
        jb = np.vectorize(lambda r, c: at[f"スカート{r}_{c}"])(row1, col)
        return p, out, ja, jb, 1.0 - np.clip(v * _SKIRT_ROWS - row, 0.0, 1.0)
    if part == "torso":
        return tube(bpos("下半身") - (0, 0.5, 0), bpos("首"), 1.5, 1.2, "下半身", spine)
    if part == "dress":
        return tube(bpos("下半身"), bpos("首") - (0, 1.0, 0), 1.7, 1.4, "下半身", spine)
    if part == "neck":
        return tube(bpos("首") - (0, 0.4, 0), bpos("頭") + (0, 0.2, 0), 0.55, 0.5, "首", "頭")
    if part == "ribbon":
        c = bpos(spine) + (0, 2.0, -1.3)
        return tube(c - (0.6, 0, 0), c + (0.6, 0, 0), 0.3, 0.3, spine, spine)
    if part == "brooch":
        return shell(bpos(spine) + (0, 1.2, -1.25), 0.3, (-1.0, 1.0), (-1.0, 1.0), spine)
    if part in ("arms", "sleeves"):
        grow = 0.3 if part == "sleeves" else 0.0
        return tube(bpos(f"{sd}腕"), bpos(f"{sd}手首"), 0.55 + grow, 0.4 + grow, f"{sd}腕",
                    f"{sd}ひじ")
    if part == "hands":
        w = bpos(f"{sd}手首")
        return tube(w, w + (1.4 * s, -0.5, 0), 0.45, 0.3, f"{sd}手首", f"{sd}手首")
    if part == "legs":
        return tube(bpos(f"{sd}足"), bpos(f"{sd}足首"), 0.75, 0.45, f"{sd}足", f"{sd}ひざ")
    if part == "shoes":
        a = bpos(f"{sd}足首")
        return tube(a + (0, 0.5, 0.4), a - (0, 1.0, 1.2), 0.55, 0.5, f"{sd}足首", f"{sd}足首")
    raise KeyError(part)


def _texture(rng, size: int, channels: int) -> np.ndarray:
    """A smooth seeded (size, size, channels) pattern. A large one varies
    around u too (periodic, so a tube's seam shows no edge) by at most a
    level or two a texel; a small one (16 texels) varies along v only, a
    few levels a row: where a pixel straddles two triangles of a part,
    the last bit of a depth decides which one's texel it shows."""
    y, x = np.mgrid[0:size, 0:size] / size
    ph = rng.uniform(0, 2 * np.pi, 3)
    wave = (90.0 if size >= 256 else 0.0) * np.stack(
        [np.cos(2 * np.pi * x + ph[0]), np.sin(2 * np.pi * x + ph[1]),
         0.6 * np.cos(2 * np.pi * x + ph[2])])
    base = rng.uniform(90, 170, 3)
    chans = [base[0] + wave[0] + 30 * y, 60 + (150 if size >= 256 else 50) * y,
             base[2] + wave[1] - 30 * y, 220 + wave[2] / 3 + 20 * y]
    return np.stack(chans[:channels], -1).round().clip(0, 255).astype(np.uint8)


def make_pmx_spec(seed: int, scale: str = "small") -> PMXSpec:
    """A seeded humanoid PMX with its textures and a 2 s, 30 fps clip, in
    MMD units (about 20 tall, facing -z, framed by the default
    ``EngineConfig`` camera).

    ``scale="small"`` (the CPU tests): at most 256 vertices and 16 bones, a
    material of each draw class, every deform type (BDEF1, BDEF2, BDEF4,
    SDEF, QDEF), every morph kind 0-10 (among them a cycle of group morphs
    past the expansion's depth limit), a sphere, a capsule and a box with
    two joints, two additional UVs. ``scale="flagship"``: the flagship's
    widths: 28,842 vertices, 101,199 indices over 19 materials (hair 1,347
    triangles, transparent 4,875, eye 928, opaque 26,583; edge flags on
    nine), 349 bones with append bones and leg and toe IK, 72 morphs of the
    vertex, bone, UV, material and group kinds (and a flip and an
    impulse), 257 rigid bodies and 406 joints, one additional UV, PNG
    diffuse textures and a BMP toon. Each clip keys bones, morphs and the
    camera."""
    if scale not in ("small", "flagship"):
        raise ValueError(f"scale {scale!r}")
    flagship = scale == "flagship"
    rng = np.random.default_rng(seed)
    bones, at = _skeleton(flagship)
    bodies, joints = _physics(rng, bones, at, flagship)
    for k in range(FLAGSHIP["bones"] - len(bones) if flagship else 0):
        src = 4 + k % 40  # helper bones up to the flagship's count, each an append bone
        at[f"補助{k}"] = len(bones)
        bones.append(_bone(f"補助{k}", bones[src].position, bones[src].parent,
                           flags=0x1A | FLAG_APPEND_ROTATE | FLAG_APPEND_MOVE,
                           append_parent=src, append_ratio=float(rng.uniform(0.2, 1.0))))

    # grids: one per material, or per side of a limb; rows stored twice
    # where the vertex count needs it (an edge of split vertices)
    table = _FLAGSHIP_MATERIALS if flagship else _SMALL_MATERIALS
    limbs = ("arms", "sleeves", "hands", "legs", "shoes")
    grids = []
    for mi, (_, part, n_tris, _, _) in enumerate(table):
        sides = 2 if (part in limbs and flagship) else 1
        for side in range(sides):
            quota = n_tris // sides + (n_tris % sides if side == 0 else 0)
            cols = min(25, max(3, quota // 6)) if flagship else (7 if quota >= 24 else 3)
            rows = -(-quota // (2 * (cols - 1))) + 1
            grids.append(dict(mat=mi, part=part, side=side, quota=quota, rows=rows,
                              cols=cols, splits=0))
    total = sum(g["rows"] * g["cols"] for g in grids)
    want = FLAGSHIP["vertices"] if flagship else total
    for g in grids:
        while want - total >= g["cols"] and g["splits"] < g["rows"] - 2:
            g["splits"] += 1
            total += g["cols"]

    cols_v = {k: [] for k in ("p", "n", "uv", "dt", "j", "w", "c", "r0", "r1")}
    tris_of = [[] for _ in table]
    span = {}
    base = 0
    for g in grids:
        rows, cols = g["rows"], g["cols"]
        v, u = np.meshgrid(np.linspace(0, 1, rows), np.linspace(0, 1, cols), indexing="ij")
        p, nrm, ja, jb, wa = _surface(g["part"], g["side"], u, v, at, bones)
        split = set(np.linspace(1, rows - 2, g["splits"]).round().astype(int)) \
            if g["splits"] else set()
        copies = np.array([2 if r in split else 1 for r in range(rows)])
        row_of = np.repeat(np.arange(rows), copies)
        dt = np.where(ja == jb, DEFORM_BDEF1, DEFORM_BDEF2)
        dt = np.where((dt == DEFORM_BDEF2) & (np.abs(v - 0.5) < 0.12), DEFORM_SDEF, dt)
        j4 = np.stack([ja, jb, np.full_like(ja, at["センター"]),
                       np.full_like(ja, at["全ての親"])], -1)
        w4 = np.stack([wa, 1.0 - wa, 0 * wa, 0 * wa], -1)
        if g["part"] in ("torso", "dress", "legs", "skirt", "hair_back"):
            blend = dt == DEFORM_BDEF2  # BDEF4 (QDEF on every fifth column)
            extra = rng.uniform(0.0, 0.1, u.shape + (2,)) * blend[..., None]
            w4[..., :2] *= (1.0 - extra.sum(-1))[..., None]
            w4[..., 2:] = extra
            col = np.arange(cols)[None, :] % 5 == 0
            dt = np.where(blend, np.where(col, DEFORM_QDEF, DEFORM_BDEF4), dt)
        bpos = np.stack([b.position for b in bones]).astype(np.float64)
        for name, a in (("p", p), ("n", nrm), ("uv", np.stack([u, v], -1)), ("dt", dt),
                        ("j", j4), ("w", w4), ("c", (bpos[ja] + bpos[jb]) / 2),
                        ("r0", bpos[ja]), ("r1", bpos[jb])):
            cols_v[name].append(a[row_of].reshape((-1,) + a.shape[2:]))
        first = base + np.concatenate([[0], np.cumsum(copies)[:-1]]) * cols
        last = first + (copies - 1) * cols
        tri = []
        for r in range(rows - 1):
            lo, hi = last[r] + np.arange(cols), first[r + 1] + np.arange(cols)
            quad = np.stack([lo[:-1], hi[:-1], hi[1:], lo[:-1], hi[1:], lo[1:]], -1)
            tri.append(quad.reshape(-1, 3))
        tri = np.concatenate(tri)[:g["quota"]]
        tris_of[g["mat"]].append(tri)
        span.setdefault(g["part"], []).append((base, base + len(row_of) * cols))
        base += len(row_of) * cols

    pad = want - base  # the last few vertices, copies of the last one, in no triangle
    take = lambda name: np.concatenate(cols_v[name] + [cols_v[name][-1][-1:]] * pad)  # noqa: E731
    pos, nrm = take("p").astype(np.float32), take("n").astype(np.float32)
    n_v = pos.shape[0]
    indices = []
    for tri_list in tris_of:
        tri = np.concatenate(tri_list)
        # front faces wind so that (b - a) x (c - a) points out of the surface
        a, b, c = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
        facing = np.einsum("ij,ij->i", np.cross(b - a, c - a), nrm[tri].sum(1))
        tri = np.where((facing < 0)[:, None], tri[:, [0, 2, 1]], tri)
        indices.append(tri.reshape(-1))
    dts = take("dt").astype(np.uint8)
    sdef = dts == DEFORM_SDEF

    tex_names = ["face.png", "hair.png", "body.png", "dress.png", _TOON]
    size = 512 if flagship else 16
    textures = {"face.png": _texture(rng, size, 4), "hair.png": _texture(rng, size, 3),
                "body.png": _texture(rng, size, 3), "dress.png": _texture(rng, size, 4)}
    ramp = np.linspace(70, 250, 32)
    textures[_TOON] = np.stack([np.tile(ramp, (32, 1)) * f for f in (1.0, 0.92, 0.95)],
                               -1).round().astype(np.uint8)
    materials = []
    for mi, (name, part, _, tex, edge) in enumerate(table):
        own_toon = mi % 3 == 0
        materials.append(PMXMaterial(
            name, part, np.array([0.9, 0.9, 0.9, _ALPHA.get(name, 1.0)], np.float32),
            np.array([0.1, 0.1, 0.1], np.float32), 5.0, np.array([0.5, 0.5, 0.5], np.float32),
            MAT_FLAG_DOUBLE_SIDED * (part in ("hair_back", "skirt")) | MAT_FLAG_EDGE * edge,
            np.array([0.2, 0.1, 0.15, 1.0], np.float32), 1.0 if edge else 0.0,
            tex_names.index(tex), -1, 0, not own_toon,
            tex_names.index(_TOON) if own_toon else mi % 10, "", indices[mi].size))

    model = PMXModel(
        name="reze" if flagship else "reze-small", english_name=scale,
        comment=f"seeded test model ({scale}, seed {seed})", english_comment="",
        version=2.1, positions=pos, normals=nrm, uvs=take("uv").astype(np.float32),
        additional_uvs=rng.uniform(0, 1, (n_v, 1 if flagship else 2, 4)).astype(np.float32),
        deform_types=dts, joints4=take("j").astype(np.int32),
        weights4=take("w").astype(np.float32),
        sdef_c=np.where(sdef[:, None], take("c"), 0).astype(np.float32),
        sdef_r0=np.where(sdef[:, None], take("r0"), 0).astype(np.float32),
        sdef_r1=np.where(sdef[:, None], take("r1"), 0).astype(np.float32),
        edge_scale=np.ones(n_v, np.float32), indices=np.concatenate(indices).astype(np.int32),
        textures=tex_names, materials=materials, bones=bones, rigid_bodies=bodies,
        joints=joints)
    model.morphs = _morphs(rng, model, span, at, flagship)
    return PMXSpec(model, textures, _motion(rng, model, at, flagship))


def _morphs(rng, model: PMXModel, span: dict, at: dict, flagship: bool) -> list:
    """Vertex and UV morphs on the face's vertices, bone morphs on the arms
    and head, material morphs (one on every material), group morphs over
    them, a flip and an impulse; the small model's four last groups form a
    cycle, which the group expansion cuts at its depth limit."""
    face = np.concatenate([np.arange(a, b) for part in ("face", *_EYES) if part in span
                           for a, b in span[part]])
    n_mats = len(model.materials)

    def pick(k):
        return np.sort(rng.choice(face, min(k, face.size), replace=False)).astype(np.int32)

    def vertex(name):
        idx = pick(24 if flagship else 6)
        return PMXMorph(name, "", 2, 1, vertex_indices=idx,
                        vertex_offsets=rng.normal(0, 0.03, (idx.size, 3)).astype(np.float32))

    def bone(name):
        names = [n for n in ("左腕", "右腕", "頭", "首", "左ひじ") if n in at][:3]
        axis = rng.normal(size=(len(names), 3))
        half = rng.uniform(0.0, 0.2, (len(names), 1))
        rot = np.concatenate([axis / np.linalg.norm(axis, axis=1, keepdims=True) * np.sin(half),
                              np.cos(half)], 1)
        return PMXMorph(name, "", 4, 2, bone_indices=np.array([at[n] for n in names], np.int32),
                        bone_translations=rng.normal(0, 0.05, (len(names), 3)).astype(np.float32),
                        bone_rotations=rot.astype(np.float32))

    def uv(name, kind):
        idx = pick(12 if flagship else 4)
        return PMXMorph(name, "", 4, kind, uv_indices=idx,
                        uv_offsets=rng.uniform(-0.02, 0.02, (idx.size, 4)).astype(np.float32))

    def material(name):
        rows = [(-1, 0), (int(rng.integers(n_mats)), 1)]
        data = np.where(np.arange(28) < 14, 1.0, 0.0) + rng.uniform(-0.3, 0.0, (2, 28))
        data[1] = rng.uniform(0.0, 0.2, 28)
        return PMXMorph(name, "", 4, 8, mat_indices=np.array([r[0] for r in rows], np.int32),
                        mat_ops=np.array([r[1] for r in rows], np.uint8),
                        mat_data=data.astype(np.float32))

    def group(name, members):
        return PMXMorph(name, "", 4, 0, group_indices=np.array(members, np.int32),
                        group_ratios=rng.uniform(0.3, 1.0, len(members)).astype(np.float32))

    if flagship:
        morphs = [vertex(f"表情{k}") for k in range(48)]
        morphs += [bone(f"ボーン{k}") for k in range(6)]
        morphs += [uv(f"UV{k}", 3) for k in range(4)] + [uv("追加UV", 4)]
        morphs += [material(f"材質{k}") for k in range(6)]
        morphs += [group(f"グループ{k}", [int(i) for i in rng.choice(48, 3, replace=False)]
                         + [48 + k % 6]) for k in range(4)]
        morphs.append(group("グループ4", [0, len(morphs) - 1]))
    else:
        morphs = [group("笑い", [1, 2]), vertex("あ"), vertex("い"), bone("腕上げ")]
        morphs += [uv(f"uv{kind - 3}", kind) for kind in range(3, 8)]
        morphs.append(material("透明"))
    flip = PMXMorph("flip", "", 4, 9)
    flip.flip = ([1, 2], [0.5, 1.0])
    impulse = PMXMorph("impulse", "", 4, 10)
    impulse.impulse = ([1], [0], rng.normal(size=(1, 3)), rng.normal(size=(1, 3)))
    morphs += [flip, impulse]
    if not flagship:
        n = len(morphs)
        morphs += [group(f"g{k}", [n + (k + 1) % 4] + ([1] if k == 3 else []))
                   for k in range(4)]
    return morphs


def _motion(rng, model: PMXModel, at: dict, flagship: bool) -> VMDMotion:
    """A 2 s clip (frames 0-60) keying the core bones every 10 frames
    (rotations up to 0.3 rad, translations on the centre and the leg IK
    within the legs' reach,
    seeded Bezier easing), morphs every 15 frames and the camera at frames
    0, 30 and 60, in shuffled record order, with a bone and a morph the
    model lacks."""
    names = [n for n in ("センター", "上半身", "上半身2", "首", "頭", "左腕", "右腕", "左ひじ",
                         "右ひじ", "下半身", "左足ＩＫ", "右足ＩＫ", "左肩", "右肩", "両目")
             if n in at] + ["存在しない"]
    frames = np.arange(0, 61, 10)
    n = len(names) * frames.size
    axis = rng.normal(size=(n, 3))
    half = rng.uniform(0.0, 0.15, (n, 1))
    rot = np.concatenate([axis / np.linalg.norm(axis, axis=1, keepdims=True) * np.sin(half),
                          np.cos(half)], 1)
    bone_names = [b for b in names for _ in frames]
    # the centre crouches and the feet lift, so the leg IK stays in reach
    low = np.array([(-0.3, -0.8, -0.3) if b == "センター" else (-0.3, 0.0, -0.3)
                    for b in bone_names])
    moves = np.array([b in ("センター", "左足ＩＫ", "右足ＩＫ") for b in bone_names])
    order = rng.permutation(n)
    morph_names = [m.name for m in model.morphs[:20 if flagship else 4]] + ["ない"]
    mframes = np.arange(0, 61, 15)
    m = len(morph_names) * mframes.size
    morder = rng.permutation(m)
    cframes = np.array([30, 0, 60])
    return VMDMotion(
        model_name=model.name,
        bone_names=[bone_names[i] for i in order],
        bone_frames=np.tile(frames, len(names))[order].astype(np.int64),
        bone_positions=((low + rng.uniform(0.0, 1.0, (n, 3)) * (0.6, 0.8, 0.6))
                        * moves[:, None])[order].astype(np.float32),
        bone_rotations=rot[order].astype(np.float32),
        bone_interp=(rng.integers(0, 128, (n, 4, 4)) / 127.0).astype(np.float32),
        morph_names=[[k for k in morph_names for _ in mframes][i] for i in morder],
        morph_frames=np.tile(mframes, len(morph_names))[morder].astype(np.int64),
        morph_weights=rng.uniform(0, 1, m)[morder].astype(np.float32),
        camera_frames=cframes.astype(np.int64),
        camera_distance=-rng.uniform(22, 26, 3).astype(np.float32),
        camera_position=np.stack([rng.uniform(-0.5, 0.5, 3), rng.uniform(10, 11, 3),
                                  rng.uniform(-0.5, 0.5, 3)], 1).astype(np.float32),
        camera_rotation=(rng.uniform(-1, 1, (3, 3)) * (0.1, 0.4, 0.05)).astype(np.float32),
        camera_fov=rng.integers(40, 50, 3).astype(np.float32))


def empty_class_spec(spec: PMXSpec, kind: str, behind=None) -> PMXSpec:
    """``spec`` with a draw class emptied: ``kind="hair"`` renames every
    hair material so that it draws in the opaque class (the hair and hair
    outline passes hold no triangle); ``kind="outline"`` clears the edge
    flag of every transparent material (the transparent outline pass holds
    none). With ``behind``, a (3,) world point behind every camera that
    will look at it, the same scene with one more material of the emptied
    class (a copy of its first material, edge flag kept) drawing one small
    triangle at that point, bound to bone 0: a witness that renders like
    the emptied scene and keeps the class non-empty."""
    if kind not in ("hair", "outline"):
        raise ValueError(f"kind {kind!r}")
    out = copy.deepcopy(spec)
    model = out.model
    if kind == "hair":
        emptied = [m for m in model.materials if m.is_hair]
        for m in emptied:
            m.name = m.name.replace("hair_f", "cap")
    else:
        emptied = [m for m in model.materials if float(m.diffuse[3]) < 1.0 and m.has_edge]
        for m in emptied:
            m.flags &= ~MAT_FLAG_EDGE
    if not emptied:
        raise ValueError(f"the model has no {kind} material to empty")
    if behind is None:
        return out
    src = next(m for m in spec.model.materials if m.is_hair) if kind == "hair" else next(
        m for m in spec.model.materials if float(m.diffuse[3]) < 1.0 and m.has_edge)
    mat = copy.deepcopy(src)
    mat.name, mat.index_count = src.name + "_witness", 3
    v = model.positions.shape[0]
    corners = np.asarray(behind, np.float32) + np.array(
        [[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.1, 0.0]], np.float32)

    def grow(a, row):
        return None if a is None else np.concatenate(
            [a, np.broadcast_to(np.asarray(row, a.dtype), (3,) + a.shape[1:])])

    model.positions = np.concatenate([model.positions, corners])
    model.normals = grow(model.normals, (0.0, 0.0, -1.0))
    model.uvs = grow(model.uvs, (0.5, 0.5))
    model.additional_uvs = grow(model.additional_uvs, 0.0)
    model.deform_types = grow(model.deform_types, DEFORM_BDEF1)
    model.joints4 = grow(model.joints4, (0, 0, 0, 0))
    model.weights4 = grow(model.weights4, (1.0, 0.0, 0.0, 0.0))
    model.sdef_c, model.sdef_r0, model.sdef_r1 = (
        grow(a, 0.0) for a in (model.sdef_c, model.sdef_r0, model.sdef_r1))
    model.edge_scale = grow(model.edge_scale, 1.0)
    model.indices = np.concatenate([model.indices,
                                    np.arange(v, v + 3, dtype=model.indices.dtype)])
    model.materials.append(mat)
    return out


def write_scene(directory: str, spec: PMXSpec) -> tuple[str, str]:
    """Write ``spec``'s model (``model.pmx``), its textures beside it (by
    extension: PNG, 24-bit BMP, TGA) and its clip (``clip.vmd``) into
    ``directory`` -> (PMX path, VMD path)."""
    os.makedirs(directory, exist_ok=True)
    pmx_path, vmd_path = os.path.join(directory, "model.pmx"), os.path.join(directory, "clip.vmd")
    write_pmx(pmx_path, spec.model)
    for name, img in spec.textures.items():
        path = os.path.join(directory, name)
        {".png": write_png, ".bmp": write_bmp, ".tga": write_tga}[os.path.splitext(name)[1]](
            path, img)
    write_vmd(vmd_path, spec.motion)
    return pmx_path, vmd_path
