"""Model building: a parsed PMX and its textures -> the padded tables of
``core.types.ModelArrays`` (counterpart of ``reze_tpu/core/build.py``).

Host-side numpy, the same arithmetic as the JAX package's builders: every
count padded to a static shape, triangles sorted by draw class, toon ramps
baked to 256-entry tables, the diffuse textures stacked into one atlas
with its mip chain (and the bilinear quad chains for the configuration
that reads them), dense skinning weights, morph tables with group morphs
expanded, IK chains, and rigid bodies and joints in the solver's form.
:class:`BuiltModel` then moves the tables to the device with
``bridge.from_jax_arrays``, so they equal what that conversion makes of
the JAX package's tables (int64, float32, bool, uint8).
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from .. import bridge
from ..formats.image import load_image
from ..formats.pmx import DEFORM_SDEF, PMXModel, load_pmx
from . import types as T
from .types import (
    CLASS_EYE,
    CLASS_HAIR,
    CLASS_OPAQUE,
    CLASS_TRANSPARENT,
    NUM_CLASSES,
    EngineConfig,
    round_up,
)

_TRANSPARENT_EPS = 0.001  # the reference engine's transparency threshold


# ---------------------------------------------------------------------------
# Math helpers (host, numpy)
# ---------------------------------------------------------------------------


def _quat_from_euler_zxy_np(rot: np.ndarray) -> np.ndarray:
    half = 0.5 * np.asarray(rot, np.float64)
    sx, sy, sz = np.sin(half[..., 0]), np.sin(half[..., 1]), np.sin(half[..., 2])
    cx, cy, cz = np.cos(half[..., 0]), np.cos(half[..., 1]), np.cos(half[..., 2])
    w = cy * cx * cz + sy * sx * sz
    x = cy * sx * cz + sy * cx * sz
    y = sy * cx * cz - cy * sx * sz
    z = cy * cx * sz - sy * sx * cz
    q = np.stack([x, y, z, w], axis=-1)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _quat_mul_np(a, b):
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def _quat_conj_np(q):
    return q * np.array([-1.0, -1.0, -1.0, 1.0], q.dtype)


def _quat_rotate_np(q, v):
    qv = q[..., :3]
    t = 2.0 * np.cross(qv, v)
    return v + q[..., 3:4] * t + np.cross(qv, t)


def _normalize_angle(a: np.ndarray) -> np.ndarray:
    """Wrap to [-pi, pi] (physics.ts:448-458)."""
    a = np.mod(a, 2.0 * np.pi)
    a = np.where(a > np.pi, a - 2.0 * np.pi, a)
    a = np.where(a < -np.pi, a + 2.0 * np.pi, a)
    return a


# ---------------------------------------------------------------------------
# Skeleton
# ---------------------------------------------------------------------------


def build_skeleton(pmx: PMXModel, pad_to: int | None = None) -> T.Skeleton:
    n = len(pmx.bones)
    j = pad_to or round_up(max(n, 1), 64)
    parent = np.full(j, -1, np.int32)
    bind = np.zeros((j, 3), np.float32)
    inv_bind = np.zeros((j, 3), np.float32)
    ap_parent = np.full(j, -1, np.int32)
    ap_ratio = np.zeros(j, np.float32)
    ap_rot = np.zeros(j, bool)
    ap_move = np.zeros(j, bool)
    after_phys = np.zeros(j, bool)

    bind[:n] = pmx.bind_translations()
    inv_bind[:n] = pmx.inverse_bind_translations()
    for i, b in enumerate(pmx.bones):
        parent[i] = b.parent if 0 <= b.parent < n else -1
        if b.append_parent >= 0 and b.append_parent < n:
            ap_parent[i] = b.append_parent
            ap_ratio[i] = b.append_ratio
            ap_rot[i] = b.append_rotate
            ap_move[i] = b.append_move
        after_phys[i] = b.after_physics

    if after_phys[:n].any():
        # parsed + stored, but pose evaluation does not reorder
        # after-physics bones (neither does the reference, model.ts:330-420);
        # surface the fidelity gap instead of hiding it
        warnings.warn(
            f"{int(after_phys[:n].sum())} bones are flagged "
            "transform-after-physics; evaluation order ignores the flag "
            "(reference-parity behavior)", stacklevel=2)

    # depth for pointer-doubling FK
    depth = np.zeros(j, np.int64)
    for i in range(n):
        p = parent[i]
        depth[i] = 0 if p < 0 else depth[p] + 1
    max_depth = int(depth.max()) if n else 0
    steps = max(1, int(np.ceil(np.log2(max_depth + 1)))) if max_depth > 0 else 1

    return T.Skeleton(
        parent=parent,
        bind_trans=bind,
        inv_bind_trans=inv_bind,
        append_parent=ap_parent,
        append_ratio=ap_ratio,
        append_rotate=ap_rot,
        append_move=ap_move,
        after_physics=after_phys,
        n_bones=n,
        doubling_steps=steps,
    )


def build_ik(pmx: PMXModel) -> T.IKChains:
    chains = [(i, b.ik) for i, b in enumerate(pmx.bones) if b.ik is not None]
    c = max(len(chains), 1)
    l = max([len(ik.links) for _, ik in chains], default=1)
    ik_bone = np.full(c, -1, np.int32)
    target = np.full(c, -1, np.int32)
    loops = np.zeros(c, np.int32)
    limit = np.zeros(c, np.float32)
    links = np.full((c, l), -1, np.int32)
    has_lim = np.zeros((c, l), bool)
    lim_min = np.zeros((c, l, 3), np.float32)
    lim_max = np.zeros((c, l, 3), np.float32)
    for ci, (bi, ik) in enumerate(chains):
        ik_bone[ci] = bi
        target[ci] = ik.target
        loops[ci] = ik.loop_count
        limit[ci] = ik.limit_angle
        for li, link in enumerate(ik.links):
            links[ci, li] = link.bone
            has_lim[ci, li] = link.has_limit
            lim_min[ci, li] = link.limit_min
            lim_max[ci, li] = link.limit_max
            # the CCD solver writes solved rotations as RAW locals
            # (skeleton/ik.py scatter-back), which is only exact when no
            # IK-link bone has append-rotate inheritance — true for every
            # MMD leg rig we know of, but assert the assumption loudly
            # instead of silently mis-solving
            lb = (pmx.bones[link.bone]
                  if 0 <= link.bone < len(pmx.bones) else None)
            if lb is not None and lb.append_parent >= 0 and lb.append_rotate:
                warnings.warn(
                    f"IK chain {ci} link bone {link.bone} has append-rotate "
                    "inheritance; the CCD solver ignores the append "
                    "premultiplication and will mis-solve this chain",
                    stacklevel=2)
    max_loops = int(loops.max()) if chains else 0
    return T.IKChains(
        ik_bone=ik_bone,
        target=target,
        loop_count=loops,
        limit_angle=limit,
        links=links,
        link_has_limit=has_lim,
        link_limit_min=lim_min,
        link_limit_max=lim_max,
        max_loops=max_loops,
        n_chains=len(chains),
    )


# ---------------------------------------------------------------------------
# Geometry + skinning
# ---------------------------------------------------------------------------


def _material_class(mat) -> int:
    """Draw-list classification (engine.ts:1948-2021)."""
    if mat.is_eye:
        return CLASS_EYE
    if mat.is_hair:
        return CLASS_HAIR
    if float(mat.diffuse[3]) < 1.0 - _TRANSPARENT_EPS:
        return CLASS_TRANSPARENT
    return CLASS_OPAQUE


def _sort_tris_by_class(
    tri_mat: np.ndarray, mat_class: np.ndarray, keep: np.ndarray | None = None
) -> tuple[np.ndarray, tuple]:
    """Stable-sort triangle ids by material class; pad each class segment to a
    multiple of 8. Returns (padded tri id array with -1 fill, class ranges)."""
    order_parts = []
    ranges = []
    start = 0
    for cls in range(NUM_CLASSES):
        sel = np.nonzero(
            (mat_class[tri_mat] == cls) & (keep if keep is not None else True)
        )[0].astype(np.int32)
        count = len(sel)
        padded = round_up(max(count, 0), 8)
        part = np.full(padded, -1, np.int32)
        part[:count] = sel
        order_parts.append(part)
        ranges.append((start, count, padded))
        start += padded
    return np.concatenate(order_parts) if order_parts else np.zeros(0, np.int32), tuple(ranges)


def build_geometry(pmx: PMXModel, v_pad: int) -> tuple[T.Geometry, np.ndarray]:
    v = pmx.positions.shape[0]
    positions = np.zeros((v_pad, 3), np.float32)
    normals = np.zeros((v_pad, 3), np.float32)
    uvs = np.zeros((v_pad, 2), np.float32)
    positions[:v] = pmx.positions
    normals[:v] = pmx.normals
    uvs[:v] = pmx.uvs

    tris = pmx.indices.reshape(-1, 3).astype(np.int32)
    t = tris.shape[0]
    tri_mat = np.zeros(t, np.int32)
    off = 0
    for mi, mat in enumerate(pmx.materials):
        cnt = mat.index_count // 3
        tri_mat[off : off + cnt] = mi
        off += cnt

    mat_class = np.array([_material_class(m) for m in pmx.materials], np.int32)
    has_edge = np.array([m.has_edge for m in pmx.materials], bool)

    order, ranges = _sort_tris_by_class(tri_mat, mat_class)
    sorted_tris = np.where(order[:, None] >= 0, tris[np.maximum(order, 0)], 0)
    sorted_mat = np.where(order >= 0, tri_mat[np.maximum(order, 0)], 0)

    o_order, o_ranges = _sort_tris_by_class(tri_mat, mat_class, keep=has_edge[tri_mat])
    o_tris = np.where(o_order[:, None] >= 0, tris[np.maximum(o_order, 0)], 0)
    o_mat = np.where(o_order >= 0, tri_mat[np.maximum(o_order, 0)], 0)

    geom = T.Geometry(
        positions=positions,
        normals=normals,
        uvs=uvs,
        tris=sorted_tris.astype(np.int32),
        tri_mat=sorted_mat.astype(np.int32),
        outline_tris=o_tris.astype(np.int32),
        outline_tri_mat=o_mat.astype(np.int32),
        n_vertices=v,
        class_ranges=ranges,
        outline_class_ranges=o_ranges,
    )
    return geom, mat_class


def build_skinning(
    pmx: PMXModel, v_pad: int, j_pad: int, dense: bool = True
) -> T.Skinning:
    v = pmx.positions.shape[0]
    joints_q, weights_q = pmx.quantized_skinning()
    joints = np.zeros((v_pad, 4), np.int32)
    weights = np.zeros((v_pad, 4), np.float32)
    joints[:v] = joints_q
    # WGSL normalizes UNORM8 weights by their sum at use (engine.ts:256-258);
    # sums are exactly 255 so this equals w8/255.
    weights[:v] = weights_q.astype(np.float32) / 255.0

    dense_w = None
    if dense:
        dense_w = np.zeros((v_pad, j_pad), np.float32)
        rows = np.repeat(np.arange(v_pad), 4)
        np.add.at(dense_w, (rows, joints.reshape(-1)), weights.reshape(-1))

    sdef_c = sdef_r0 = sdef_r1 = is_sdef = None
    if pmx.sdef_c is not None:
        sdef_c = np.zeros((v_pad, 3), np.float32)
        sdef_r0 = np.zeros((v_pad, 3), np.float32)
        sdef_r1 = np.zeros((v_pad, 3), np.float32)
        is_sdef = np.zeros(v_pad, bool)
        sdef_c[:v] = pmx.sdef_c
        sdef_r0[:v] = pmx.sdef_r0
        sdef_r1[:v] = pmx.sdef_r1
        is_sdef[:v] = pmx.deform_types == DEFORM_SDEF

    return T.Skinning(
        joints=joints,
        weights=weights,
        weights_dense=dense_w,
        sdef_c=sdef_c,
        sdef_r0=sdef_r0,
        sdef_r1=sdef_r1,
        is_sdef=is_sdef,
    )


# ---------------------------------------------------------------------------
# Materials + textures
# ---------------------------------------------------------------------------


def _default_toon_lut() -> np.ndarray:
    """Default gray ramp (engine.ts:1861-1873)."""
    i = np.arange(256, dtype=np.float32)
    gray = np.floor(128.0 + (i / 255.0) * 127.0) / 255.0
    return np.repeat(gray[:, None], 3, axis=1)


def _bake_toon_lut(img: np.ndarray) -> np.ndarray:
    """Sample the toon texture along v=0.5 into a 256-entry RGB LUT with
    bilinear filtering (matches WGSL textureSample(toon, (nDotL, 0.5)))."""
    h, w = img.shape[:2]
    fy = 0.5 * h - 0.5
    y0 = int(np.clip(np.floor(fy), 0, h - 1))
    y1 = min(y0 + 1, h - 1)
    ty = fy - y0
    row = img[y0, :, :3].astype(np.float32) * (1 - ty) + img[y1, :, :3].astype(np.float32) * ty
    u = np.arange(256, dtype=np.float32) / 255.0
    fx = u * w - 0.5
    x0 = np.clip(np.floor(fx), 0, w - 1).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    tx = (fx - x0)[:, None]
    lut = row[x0] * (1 - tx) + row[x1] * tx
    return (lut / 255.0).astype(np.float32)


def build_materials_and_atlas(
    pmx: PMXModel, model_dir: str, cfg: EngineConfig
) -> tuple[T.Materials, T.TextureAtlas]:
    m = len(pmx.materials)

    # Load all referenced textures once
    images: list[np.ndarray | None] = []
    for tex in pmx.textures:
        path = os.path.join(model_dir, tex.replace("\\", "/"))
        images.append(load_image(path))

    # Diffuse atlas: only textures used as diffuse somewhere
    used = sorted(
        {
            mat.texture_index
            for mat in pmx.materials
            if 0 <= mat.texture_index < len(images) and images[mat.texture_index] is not None
        }
    )
    remap = {ti: i for i, ti in enumerate(used)}
    if used:
        max_h = max(images[ti].shape[0] for ti in used)
        max_w = max(images[ti].shape[1] for ti in used)
    else:
        max_h = max_w = 8
    texels = np.zeros((max(len(used), 1), max_h, max_w, 4), np.uint8)
    texels[..., :] = 255
    sizes = np.ones((max(len(used), 1), 2), np.int32)
    for i, ti in enumerate(used):
        img = images[ti]
        texels[i, : img.shape[0], : img.shape[1]] = img
        sizes[i] = (img.shape[0], img.shape[1])
    mip_flat, mip_base = build_mip_chain(texels, sizes)
    # only the variant the config's fetch path reads (the chains are 4x
    # the base atlas: ~213 MB mip / ~336 MB flat on the reference model)
    mip_quad = flat_quad = None
    if cfg.albedo_quad and cfg.albedo_bilinear:
        if cfg.albedo_mips:
            mip_quad = build_quad_chain(mip_flat, mip_base, sizes)
        else:
            flat_quad = build_quad_flat(texels, sizes)

    alpha = np.zeros(m, np.float32)
    diffuse_rgb = np.zeros((m, 3), np.float32)
    edge_color = np.zeros((m, 4), np.float32)
    edge_size = np.zeros(m, np.float32)
    tex_id = np.full(m, -1, np.int32)
    toon_lut = np.zeros((m, 256, 3), np.float32)
    is_eye = np.zeros(m, bool)
    is_hair = np.zeros(m, bool)
    is_transparent = np.zeros(m, bool)
    default_lut = _default_toon_lut()

    for i, mat in enumerate(pmx.materials):
        alpha[i] = mat.diffuse[3]
        diffuse_rgb[i] = mat.diffuse[:3]
        edge_color[i] = mat.edge_color
        edge_size[i] = mat.edge_size
        tex_id[i] = remap.get(mat.texture_index, -1)
        is_eye[i] = mat.is_eye
        is_hair[i] = mat.is_hair
        is_transparent[i] = float(mat.diffuse[3]) < 1.0 - _TRANSPARENT_EPS
        toon_img = None
        if not mat.shared_toon and 0 <= mat.toon_texture_index < len(images):
            toon_img = images[mat.toon_texture_index]
        toon_lut[i] = _bake_toon_lut(toon_img) if toon_img is not None else default_lut

    mats = T.Materials(
        alpha=alpha,
        diffuse_rgb=diffuse_rgb,
        edge_color=edge_color,
        edge_size=edge_size,
        tex_id=tex_id,
        toon_lut=toon_lut,
        is_eye=is_eye,
        is_hair=is_hair,
        is_transparent=is_transparent,
    )
    return mats, T.TextureAtlas(texels=texels, sizes=sizes,
                                mip_flat=mip_flat, mip_base=mip_base,
                                mip_quad=mip_quad, flat_quad=flat_quad)


def build_mip_chain(
    texels: np.ndarray, sizes: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Dense mip pyramid for every texture, level 0 included.

    Level l+1 is the 2x2 box average of level l (odd trailing row/column
    dropped), down to 1x1; every texture carries the same global level
    count. Returns (mip_flat (S, 4) u8, mip_base (N, L) i32): level l of
    texture i spans ``mip_flat[mip_base[i, l] : + h_l * w_l]`` row-major.
    """
    n = texels.shape[0]
    hw = [(int(sizes[i, 0]), int(sizes[i, 1])) for i in range(n)]
    n_levels = max(1, max(max(h, w) for h, w in hw).bit_length())
    chunks: list[np.ndarray] = []
    base = np.zeros((n, n_levels), np.int64)
    off = 0
    for i in range(n):
        h, w = hw[i]
        img = texels[i, :h, :w].astype(np.float32)
        for lvl in range(n_levels):
            base[i, lvl] = off
            chunks.append(np.clip(np.rint(img), 0, 255).astype(np.uint8).reshape(-1, 4))
            off += img.shape[0] * img.shape[1]
            if img.shape[0] > 1:
                img = img[: img.shape[0] // 2 * 2]
                img = 0.5 * (img[0::2] + img[1::2])
            if img.shape[1] > 1:
                img = img[:, : img.shape[1] // 2 * 2]
                img = 0.5 * (img[:, 0::2] + img[:, 1::2])
    return np.concatenate(chunks, axis=0), base.astype(np.int32)


def _quad_pack_img(img: np.ndarray) -> np.ndarray:
    """(h, w, 4) u8 -> (h, w, 16): each texel's 2x2 footprint [self,
    right, down, right+down], edge-clamped."""
    h, w = img.shape[:2]
    xr = np.minimum(np.arange(w) + 1, w - 1)
    yd = np.minimum(np.arange(h) + 1, h - 1)
    r = img[:, xr]
    d = img[yd]
    return np.concatenate([img, r, d, d[:, xr]], axis=-1)


def build_quad_chain(
    mip_flat: np.ndarray, mip_base: np.ndarray, sizes: np.ndarray
) -> np.ndarray:
    """(S, 4) u8 mip chain -> (S, 16) u8 quad footprints."""
    n, n_levels = mip_base.shape
    quad = np.empty((mip_flat.shape[0], 16), np.uint8)
    for i in range(n):
        h, w = int(sizes[i, 0]), int(sizes[i, 1])
        for lvl in range(n_levels):
            hl, wl = max(h >> lvl, 1), max(w >> lvl, 1)
            b = int(mip_base[i, lvl])
            img = mip_flat[b:b + hl * wl].reshape(hl, wl, 4)
            quad[b:b + hl * wl] = _quad_pack_img(img).reshape(-1, 16)
    return quad


def build_quad_flat(texels: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Quad footprints of the padded level-0 atlas (stride = max width);
    texels outside a texture's real size pack as self-copies."""
    n, mh, mw, _ = texels.shape
    quad = np.concatenate([texels] * 4, axis=-1)
    for i in range(n):
        h, w = int(sizes[i, 0]), int(sizes[i, 1])
        quad[i, :h, :w] = _quad_pack_img(texels[i, :h, :w])
    return quad.reshape(-1, 16)


# ---------------------------------------------------------------------------
# Morphs
# ---------------------------------------------------------------------------


def build_morphs(
    pmx: PMXModel, v_pad: int, j_pad: int, n_mats: int
) -> tuple[T.Morphs, dict[str, int]]:
    """Dense morph tables (all kinds) with group morphs expanded."""
    vertex_like = [mo for mo in pmx.morphs]
    name_to_id = {mo.name: i for i, mo in enumerate(vertex_like)}
    nm = max(len(vertex_like), 1)
    offsets = np.zeros((nm, v_pad, 3), np.float32)
    bone_trans = np.zeros((nm, j_pad, 3), np.float32)
    bone_rotvec = np.zeros((nm, j_pad, 3), np.float32)
    uv_offsets = np.zeros((nm, v_pad, 2), np.float32)
    mm = max(n_mats, 1)
    mat_cols = {
        "alpha_dmul": np.zeros((nm, mm), np.float32),
        "alpha_add": np.zeros((nm, mm), np.float32),
        "edge_a_dmul": np.zeros((nm, mm), np.float32),
        "edge_a_add": np.zeros((nm, mm), np.float32),
    }
    has = {"bone": False, "uv": False, "material": False}

    def quat_log(q: np.ndarray) -> np.ndarray:
        """(n, 4) quaternion -> (n, 3) rotation vector (axis * angle)."""
        q = q * np.sign(q[:, 3:4] + 1e-30)  # shortest arc
        s = np.linalg.norm(q[:, :3], axis=1)
        angle = 2.0 * np.arctan2(s, np.clip(q[:, 3], -1.0, 1.0))
        axis = q[:, :3] / np.maximum(s, 1e-12)[:, None]
        return axis * angle[:, None]

    def accumulate(dst: int, morph, ratio: float, depth: int = 0):
        if depth > 4:
            return
        if morph.kind == 1 and morph.vertex_indices is not None:
            np.add.at(offsets[dst], morph.vertex_indices, morph.vertex_offsets * ratio)
        elif morph.kind == 0 and morph.group_indices is not None:
            for gi, gr in zip(morph.group_indices, morph.group_ratios):
                if 0 <= gi < len(pmx.morphs):
                    accumulate(dst, pmx.morphs[gi], ratio * float(gr), depth + 1)
        elif morph.kind == 2 and morph.bone_indices is not None:
            has["bone"] = True
            ok = (morph.bone_indices >= 0) & (morph.bone_indices < j_pad)
            bi = morph.bone_indices[ok]
            np.add.at(bone_trans[dst], bi, morph.bone_translations[ok] * ratio)
            np.add.at(bone_rotvec[dst], bi, quat_log(morph.bone_rotations[ok]) * ratio)
        elif morph.kind == 3 and morph.uv_indices is not None:
            # uv0 only; kinds 4-7 (extra uv layers) do not affect rendering
            has["uv"] = True
            ok = (morph.uv_indices >= 0) & (morph.uv_indices < v_pad)
            np.add.at(uv_offsets[dst], morph.uv_indices[ok],
                      morph.uv_offsets[ok, :2] * ratio)
        elif morph.kind == 8 and morph.mat_indices is not None:
            has["material"] = True
            for mi, op, dat in zip(morph.mat_indices, morph.mat_ops, morph.mat_data):
                rows = range(n_mats) if mi < 0 else [int(mi)]
                alpha_v = float(dat[3])  # diffuse.a
                edge_a_v = float(dat[14])  # edge_color.a
                for row in rows:
                    if row >= mm:
                        continue
                    if op == 0:  # multiply: factor(w) = 1 + w*(v-1)
                        mat_cols["alpha_dmul"][dst, row] += ratio * (alpha_v - 1.0)
                        mat_cols["edge_a_dmul"][dst, row] += ratio * (edge_a_v - 1.0)
                    else:  # add
                        mat_cols["alpha_add"][dst, row] += ratio * alpha_v
                        mat_cols["edge_a_add"][dst, row] += ratio * edge_a_v

    for i, mo in enumerate(vertex_like):
        accumulate(i, mo, 1.0)

    return T.Morphs(
        offsets=offsets,
        bone_trans=bone_trans if has["bone"] else np.zeros((1, 1, 3), np.float32),
        bone_rotvec=bone_rotvec if has["bone"] else np.zeros((1, 1, 3), np.float32),
        uv_offsets=uv_offsets if has["uv"] else np.zeros((1, 1, 2), np.float32),
        mat_alpha_dmul=mat_cols["alpha_dmul"],
        mat_alpha_add=mat_cols["alpha_add"],
        mat_edge_a_dmul=mat_cols["edge_a_dmul"],
        mat_edge_a_add=mat_cols["edge_a_add"],
        n_morphs=len(vertex_like),
        has_bone=has["bone"],
        has_uv=has["uv"],
        has_material=has["material"],
    ), name_to_id


# ---------------------------------------------------------------------------
# Physics tables
# ---------------------------------------------------------------------------


def _body_inertia_diag(shape: int, size: np.ndarray, mass: float) -> np.ndarray:
    """Local inertia diagonal, following Bullet's shape conventions
    (physics.ts:196-216: sphere r=size.x; box half-extents=size; capsule
    radius=size.x, cylinder height=size.y)."""
    sx, sy, sz = [max(float(s), 1e-4) for s in size]
    if shape == 0:  # sphere
        i = 0.4 * mass * sx * sx
        return np.array([i, i, i], np.float32)
    if shape == 2:  # capsule along Y — Bullet approximates via enclosing box
        hx, hy, hz = sx, 0.5 * sy + sx, sx
        return np.array(
            [
                mass / 3.0 * (hy * hy + hz * hz),
                mass / 3.0 * (hx * hx + hz * hz),
                mass / 3.0 * (hx * hx + hy * hy),
            ],
            np.float32,
        )
    # box (half extents)
    return np.array(
        [
            mass / 3.0 * (sy * sy + sz * sz),
            mass / 3.0 * (sx * sx + sz * sz),
            mass / 3.0 * (sx * sx + sy * sy),
        ],
        np.float32,
    )


def build_physics(pmx: PMXModel, nb_pad: int | None = None, nj_pad: int | None = None) -> T.PhysicsModel:
    n = len(pmx.rigid_bodies)
    nj = len(pmx.joints)
    nb_pad = nb_pad or round_up(max(n, 1), 8)
    nj_pad = nj_pad or round_up(max(nj, 1), 8)

    bone_index = np.full(nb_pad, -1, np.int32)
    shape = np.zeros(nb_pad, np.int32)
    size = np.ones((nb_pad, 3), np.float32)
    mass = np.zeros(nb_pad, np.float32)
    inv_mass = np.zeros(nb_pad, np.float32)
    # Non-dynamic (static/kinematic/padded) bodies get zero local inertia
    # -> zero inverse inertia, matching Bullet's localInertia=(0,0,0) for
    # mass-0 bodies (physics.ts:237-240): anchors must not absorb angular
    # corrections in the joint/contact solves.
    inertia = np.zeros((nb_pad, 3), np.float32)
    lin_damp = np.zeros(nb_pad, np.float32)
    ang_damp = np.zeros(nb_pad, np.float32)
    restitution = np.zeros(nb_pad, np.float32)
    friction = np.zeros(nb_pad, np.float32)
    is_dyn = np.zeros(nb_pad, bool)
    no_contact = np.ones(nb_pad, bool)
    group = np.zeros(nb_pad, np.int32)
    mask = np.zeros(nb_pad, np.int32)
    off_pos = np.zeros((nb_pad, 3), np.float32)
    off_quat = np.zeros((nb_pad, 4), np.float32)
    off_quat[:, 3] = 1.0
    bind_pos = np.full((nb_pad, 3), 1e6, np.float32)
    valid = np.zeros(nb_pad, bool)

    n_bones = len(pmx.bones)
    bone_pos = (
        np.stack([b.position for b in pmx.bones]) if n_bones else np.zeros((0, 3))
    )

    for i, rb in enumerate(pmx.rigid_bodies):
        bone_index[i] = rb.bone if 0 <= rb.bone < n_bones else -1
        shape[i] = rb.shape
        size[i] = rb.size
        dyn = rb.mode == 1
        m = rb.mass if dyn else 0.0
        mass[i] = m
        inv_mass[i] = 1.0 / m if (dyn and m > 0) else 0.0
        inertia[i] = _body_inertia_diag(rb.shape, rb.size, m) if dyn and m > 0 else 0.0
        lin_damp[i] = rb.linear_damping
        ang_damp[i] = rb.angular_damping
        restitution[i] = rb.restitution
        friction[i] = rb.friction
        is_dyn[i] = dyn
        zero_volume = (
            (rb.shape == 0 and rb.size[0] == 0)
            or (rb.shape == 1 and (rb.size == 0).any())
            or (rb.shape == 2 and (rb.size[:2] == 0).any())
        )
        no_contact[i] = (rb.collision_mask == 0) or zero_volume
        group[i] = rb.group
        mask[i] = rb.collision_mask
        # bone-local body offset: translation-only inverse bind means
        # offset = (shapePos - bonePos, shapeRot)  (physics.ts:572-596)
        q = _quat_from_euler_zxy_np(rb.rotation)
        if bone_index[i] >= 0:
            off_pos[i] = rb.position - bone_pos[bone_index[i]]
        else:
            off_pos[i] = rb.position
        off_quat[i] = q
        bind_pos[i] = rb.position
        valid[i] = True

    jba = np.full(nj_pad, -1, np.int32)
    jbb = np.full(nj_pad, -1, np.int32)
    jpa = np.zeros((nj_pad, 3), np.float32)
    jqa = np.zeros((nj_pad, 4), np.float32)
    jqa[:, 3] = 1.0
    jpb = np.zeros((nj_pad, 3), np.float32)
    jqb = np.zeros((nj_pad, 4), np.float32)
    jqb[:, 3] = 1.0
    jlmin = np.zeros((nj_pad, 3), np.float32)
    jlmax = np.zeros((nj_pad, 3), np.float32)
    jamin = np.zeros((nj_pad, 3), np.float32)
    jamax = np.zeros((nj_pad, 3), np.float32)
    jslin = np.zeros((nj_pad, 3), np.float32)
    jsang = np.zeros((nj_pad, 3), np.float32)
    jvalid = np.zeros(nj_pad, bool)

    for i, jt in enumerate(pmx.joints):
        if not (0 <= jt.body_a < n and 0 <= jt.body_b < n):
            continue
        jba[i] = jt.body_a
        jbb[i] = jt.body_b
        # Joint frames in body-local space at bind pose (physics.ts:307-339)
        jq = _quat_from_euler_zxy_np(jt.rotation)
        for (bi, pos_out, quat_out) in ((jt.body_a, jpa, jqa), (jt.body_b, jpb, jqb)):
            rb = pmx.rigid_bodies[bi]
            bq = _quat_from_euler_zxy_np(rb.rotation)
            bq_inv = _quat_conj_np(bq)
            pos_out[i] = _quat_rotate_np(bq_inv, jt.position - rb.position)
            quat_out[i] = _quat_mul_np(bq_inv, jq)
        jlmin[i] = jt.position_min
        jlmax[i] = jt.position_max
        jamin[i] = _normalize_angle(jt.rotation_min)
        jamax[i] = _normalize_angle(jt.rotation_max)
        jslin[i] = jt.spring_position
        jsang[i] = jt.spring_rotation
        jvalid[i] = True

    return T.PhysicsModel(
        bone_index=bone_index,
        shape=shape,
        size=size,
        mass=mass,
        inv_mass=inv_mass,
        inv_inertia_local=np.where(inertia > 0, 1.0 / np.maximum(inertia, 1e-12), 0.0).astype(np.float32),
        linear_damping=lin_damp,
        angular_damping=ang_damp,
        restitution=restitution,
        friction=friction,
        is_dynamic=is_dyn,
        no_contact=no_contact,
        group=group,
        collision_mask=mask,
        body_offset_pos=off_pos,
        body_offset_quat=off_quat,
        bind_pos=bind_pos,
        valid=valid,
        joint_body_a=jba,
        joint_body_b=jbb,
        joint_pos_a=jpa,
        joint_quat_a=jqa,
        joint_pos_b=jpb,
        joint_quat_b=jqb,
        joint_lin_min=jlmin,
        joint_lin_max=jlmax,
        joint_ang_min=jamin,
        joint_ang_max=jamax,
        joint_spring_lin=jslin,
        joint_spring_ang=jsang,
        joint_valid=jvalid,
        n_bodies=n,
        n_joints=nj,
    )


# ---------------------------------------------------------------------------
# Top-level
# ---------------------------------------------------------------------------


class BuiltModel:
    """A built model: its tables on ``device`` and its name lookups."""

    def __init__(self, pmx: PMXModel, model_dir: str, cfg: EngineConfig, device="cuda"):
        v = pmx.positions.shape[0]
        v_pad = round_up(max(v, 1), 128)
        skeleton = build_skeleton(pmx)
        j_pad = skeleton.parent.shape[0]
        geometry, _ = build_geometry(pmx, v_pad)
        skinning = build_skinning(pmx, v_pad, j_pad)
        materials, atlas = build_materials_and_atlas(pmx, model_dir, cfg)
        morphs, morph_name_to_id = build_morphs(
            pmx, v_pad, j_pad, materials.alpha.shape[0])
        physics = build_physics(pmx)
        ik = build_ik(pmx)

        arrays = T.ModelArrays(
            skeleton=skeleton,
            ik=ik,
            skinning=skinning,
            geometry=geometry,
            materials=materials,
            atlas=atlas,
            morphs=morphs,
            physics=physics,
        )
        self.arrays = bridge.from_jax_arrays(arrays, device)
        self.bone_name_to_id = {b.name: i for i, b in enumerate(pmx.bones)}
        self.bone_names = [b.name for b in pmx.bones]
        self.morph_name_to_id = morph_name_to_id
        self.pmx = pmx
        self.config = cfg


def load_model(path: str, cfg: EngineConfig | None = None, device="cuda") -> BuiltModel:
    """Parse the PMX at ``path``, read its textures and build it on ``device``."""
    cfg = cfg or EngineConfig()
    pmx = load_pmx(path)
    return BuiltModel(pmx, os.path.dirname(path), cfg, device)
