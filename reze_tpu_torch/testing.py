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
"""

from __future__ import annotations

import numpy as np

from . import bridge
from .core import types as T
from .core.build import build_mip_chain, build_quad_chain, build_quad_flat


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
