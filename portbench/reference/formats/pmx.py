"""PMX 2.0/2.1 binary model parser (counterpart of
``reze_tpu/formats/pmx.py``; numpy, on the host).

Parses the whole format: vertices with every deform type (BDEF1/2/4, SDEF,
QDEF), indices of 1, 2 or 4 bytes, UTF-16LE or UTF-8 text, materials,
bones with IK, append and axis data, morphs of kinds 0-10 (the PMX 2.1
flip and impulse kinds are read past), display frames, rigid bodies and
joints, in Python alone (a frozen copy of the port's ``formats/pmx.py``
without its native parser).

The derived tables follow the reference engine's loader: parent-relative
bind translations, translation-only inverse binds, and UNORM8 skinning
weights that sum to exactly 255 (invalid joints zeroed, the remainder
moved onto the largest weight); materials are classed eye, face or hair by
keywords in their names.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


# PMX bone flag bits
FLAG_TAIL_IS_BONE = 0x0001
FLAG_ROTATABLE = 0x0002
FLAG_TRANSLATABLE = 0x0004
FLAG_VISIBLE = 0x0008
FLAG_ENABLED = 0x0010
FLAG_IK = 0x0020
FLAG_APPEND_LOCAL = 0x0080
FLAG_APPEND_ROTATE = 0x0100
FLAG_APPEND_MOVE = 0x0200
FLAG_AXIS_LIMIT = 0x0400
FLAG_LOCAL_AXIS = 0x0800
FLAG_AFTER_PHYSICS = 0x1000
FLAG_EXTERNAL_PARENT = 0x2000

# Material flag bits
MAT_FLAG_DOUBLE_SIDED = 0x01
MAT_FLAG_GROUND_SHADOW = 0x02
MAT_FLAG_CAST_SHADOW = 0x04
MAT_FLAG_RECEIVE_SHADOW = 0x08
MAT_FLAG_EDGE = 0x10

# Skinning deform types
DEFORM_BDEF1 = 0
DEFORM_BDEF2 = 1
DEFORM_BDEF4 = 2
DEFORM_SDEF = 3
DEFORM_QDEF = 4

# Eye/face/hair classification keywords of the reference engine
_EYE_KEYWORDS = ("目", "瞳", "eye", "pupil", "iris", "目白", "眼", "睛", "眉")
_FACE_KEYWORDS = ("face", "脸")
_HAIR_KEYWORDS = ("hair_f",)


@dataclass
class PMXIKLink:
    bone: int
    has_limit: bool
    limit_min: np.ndarray  # (3,) radians
    limit_max: np.ndarray  # (3,) radians


@dataclass
class PMXIK:
    target: int
    loop_count: int
    limit_angle: float  # radians per-iteration clamp
    links: list[PMXIKLink]


@dataclass
class PMXBone:
    name: str
    english_name: str
    position: np.ndarray  # (3,) absolute bind position
    parent: int
    transform_order: int
    flags: int
    tail_bone: int = -1
    tail_offset: np.ndarray | None = None
    append_parent: int = -1
    append_ratio: float = 1.0
    axis_limit: np.ndarray | None = None
    local_axis_x: np.ndarray | None = None
    local_axis_z: np.ndarray | None = None
    external_parent: int = -1
    ik: PMXIK | None = None

    @property
    def append_rotate(self) -> bool:
        return bool(self.flags & FLAG_APPEND_ROTATE)

    @property
    def append_move(self) -> bool:
        return bool(self.flags & FLAG_APPEND_MOVE)

    @property
    def is_ik(self) -> bool:
        return bool(self.flags & FLAG_IK)

    @property
    def after_physics(self) -> bool:
        return bool(self.flags & FLAG_AFTER_PHYSICS)


@dataclass
class PMXMaterial:
    name: str
    english_name: str
    diffuse: np.ndarray  # (4,)
    specular: np.ndarray  # (3,)
    shininess: float
    ambient: np.ndarray  # (3,)
    flags: int
    edge_color: np.ndarray  # (4,)
    edge_size: float
    texture_index: int
    sphere_texture_index: int
    sphere_mode: int
    shared_toon: bool
    toon_texture_index: int
    comment: str
    index_count: int  # number of *indices* ("vertexCount" in the reference)

    @property
    def is_eye(self) -> bool:
        low = self.name.lower()
        return any(k in low for k in _EYE_KEYWORDS)

    @property
    def is_face(self) -> bool:
        low = self.name.lower()
        return any(k in low for k in _FACE_KEYWORDS)

    @property
    def is_hair(self) -> bool:
        low = self.name.lower()
        return any(k in low for k in _HAIR_KEYWORDS)

    @property
    def has_edge(self) -> bool:
        return bool(self.flags & MAT_FLAG_EDGE) and self.edge_size > 0


@dataclass
class PMXMorph:
    name: str
    english_name: str
    panel: int
    kind: int  # 0 group, 1 vertex, 2 bone, 3..7 uv, 8 material
    # vertex morph
    vertex_indices: np.ndarray | None = None  # (n,) int32
    vertex_offsets: np.ndarray | None = None  # (n, 3) f32
    # group morph
    group_indices: np.ndarray | None = None
    group_ratios: np.ndarray | None = None
    # bone morph
    bone_indices: np.ndarray | None = None
    bone_translations: np.ndarray | None = None  # (n, 3)
    bone_rotations: np.ndarray | None = None  # (n, 4) quaternion
    # uv morph
    uv_indices: np.ndarray | None = None
    uv_offsets: np.ndarray | None = None  # (n, 4)
    # material morph
    mat_indices: np.ndarray | None = None  # (n,) int32, -1 = all materials
    mat_ops: np.ndarray | None = None  # (n,) u8: 0 multiply, 1 add
    mat_data: np.ndarray | None = None  # (n, 28) [diffuse4, specular3,
    # shininess, ambient3, edge_color4, edge_size, tex4, env4, toon4]


@dataclass
class PMXRigidBody:
    name: str
    english_name: str
    bone: int
    group: int
    collision_mask: int
    shape: int  # 0 sphere, 1 box, 2 capsule
    size: np.ndarray  # (3,)
    position: np.ndarray  # (3,) bind-pose world space
    rotation: np.ndarray  # (3,) ZXY euler radians
    mass: float
    linear_damping: float
    angular_damping: float
    restitution: float
    friction: float
    mode: int  # 0 static(follow-bone), 1 dynamic, 2 kinematic


@dataclass
class PMXJoint:
    name: str
    english_name: str
    kind: int
    body_a: int
    body_b: int
    position: np.ndarray  # (3,)
    rotation: np.ndarray  # (3,) ZXY euler radians
    position_min: np.ndarray
    position_max: np.ndarray
    rotation_min: np.ndarray
    rotation_max: np.ndarray
    spring_position: np.ndarray
    spring_rotation: np.ndarray


@dataclass
class PMXModel:
    name: str = ""
    english_name: str = ""
    comment: str = ""
    english_comment: str = ""
    version: float = 2.0
    # vertices
    positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    uvs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    additional_uvs: np.ndarray | None = None  # (V, n, 4)
    deform_types: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    joints4: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.int32))
    weights4: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))
    sdef_c: np.ndarray | None = None  # (V, 3); zero rows for non-SDEF verts
    sdef_r0: np.ndarray | None = None
    sdef_r1: np.ndarray | None = None
    edge_scale: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    # topology / appearance
    indices: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    textures: list[str] = field(default_factory=list)
    materials: list[PMXMaterial] = field(default_factory=list)
    bones: list[PMXBone] = field(default_factory=list)
    morphs: list[PMXMorph] = field(default_factory=list)
    rigid_bodies: list[PMXRigidBody] = field(default_factory=list)
    joints: list[PMXJoint] = field(default_factory=list)

    # ---- reference-parity derived data ------------------------------------

    def bind_translations(self) -> np.ndarray:
        """Parent-relative bind translations (pmx-loader.ts:416-442)."""
        n = len(self.bones)
        out = np.zeros((n, 3), np.float32)
        for i, b in enumerate(self.bones):
            if 0 <= b.parent < n:
                out[i] = b.position - self.bones[b.parent].position
            else:
                out[i] = b.position
        return out

    def inverse_bind_translations(self) -> np.ndarray:
        """Per-bone inverse-bind as pure translations = -abs position.

        The reference computes bone world matrices by chaining bind
        translations and inverts only the translation (pmx-loader.ts:791-824);
        that chain telescopes to the absolute bone position.
        """
        return -np.stack([b.position for b in self.bones]).astype(np.float32)

    def quantized_skinning(self) -> tuple[np.ndarray, np.ndarray]:
        """(joints u16 (V,4), weights u8 (V,4) summing to 255).

        Mirrors the reference's parse-time quantization
        (pmx-loader.ts:136-184) and load-time fixup (pmx-loader.ts:856-939).
        """
        v = self.positions.shape[0]
        n_bones = len(self.bones)
        joints = np.zeros((v, 4), np.int64)
        w8 = np.zeros((v, 4), np.int64)

        dt = self.deform_types
        j_raw = self.joints4
        w_raw = self.weights4

        # BDEF1: weight [255,0,0,0]
        m1 = dt == DEFORM_BDEF1
        joints[m1, 0] = np.maximum(j_raw[m1, 0], 0)
        w8[m1, 0] = 255

        # BDEF2 / SDEF: w0 = round(w*255) clamped, w1 = 255-w0
        m2 = (dt == DEFORM_BDEF2) | (dt == DEFORM_SDEF)
        joints[m2, 0] = np.maximum(j_raw[m2, 0], 0)
        joints[m2, 1] = np.maximum(j_raw[m2, 1], 0)
        w0 = np.clip(np.round(w_raw[m2, 0] * 255.0), 0, 255).astype(np.int64)
        w8[m2, 0] = w0
        w8[m2, 1] = np.clip(255 - w0, 0, 255)

        # BDEF4 / QDEF: clamp to [0,1], round, renormalize to 255
        m4 = (dt == DEFORM_BDEF4) | (dt == DEFORM_QDEF)
        joints[m4] = np.maximum(j_raw[m4], 0)
        wq = np.round(np.clip(w_raw[m4], 0.0, 1.0) * 255.0)
        s = wq.sum(axis=1)
        out4 = np.zeros_like(wq, dtype=np.int64)
        zero = s == 0
        out4[zero, 0] = 255
        nz = ~zero
        scale = np.where(s == 0, 1.0, 255.0 / np.maximum(s, 1))
        scaled = np.clip(np.round(wq * scale[:, None]), 0, 255).astype(np.int64)
        accum = scaled[:, :3].sum(axis=1)
        scaled[:, 3] = np.clip(255 - accum, 0, 255)
        out4[nz] = scaled[nz]
        w8[m4] = out4

        # fixup: zero weights for out-of-range joints, renormalize to 255
        invalid = (joints < 0) | (joints >= max(n_bones, 1))
        joints = np.where(joints < 0, 0, np.minimum(joints, max(n_bones - 1, 0)))
        w8 = np.where(invalid, 0, w8)
        s = w8.sum(axis=1)
        dead = s == 0
        w8[dead] = [255, 0, 0, 0]
        joints[dead] = 0
        need = (~dead) & (s != 255)
        if need.any():
            sc = 255.0 / s[need]
            scaled = np.clip(np.round(w8[need, :3] * sc[:, None]), 0, 255).astype(np.int64)
            w_fix = np.concatenate(
                [scaled, np.clip(255 - scaled.sum(axis=1, keepdims=True), 0, 255)],
                axis=1,
            )
            w8[need] = w_fix
        # final diff redistribution onto the largest weight
        diff = 255 - w8.sum(axis=1)
        if (diff != 0).any():
            idx = np.argmax(w8, axis=1)
            w8[np.arange(v), idx] = np.clip(w8[np.arange(v), idx] + diff, 0, 255)
        return joints.astype(np.uint16), w8.astype(np.uint8)


class _Reader:
    __slots__ = ("buf", "pos", "encoding")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.encoding = "utf-16-le"

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def i8(self) -> int:
        v = struct.unpack_from("<b", self.buf, self.pos)[0]
        self.pos += 1
        return v

    def u16(self) -> int:
        v = struct.unpack_from("<H", self.buf, self.pos)[0]
        self.pos += 2
        return v

    def i16(self) -> int:
        v = struct.unpack_from("<h", self.buf, self.pos)[0]
        self.pos += 2
        return v

    def i32(self) -> int:
        v = struct.unpack_from("<i", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def f32(self) -> float:
        v = struct.unpack_from("<f", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def fvec(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.buf, np.float32, n, self.pos).copy()
        self.pos += 4 * n
        return v

    def skip(self, n: int) -> None:
        self.pos += n

    def text(self) -> str:
        n = self.i32()
        if n <= 0:
            return ""
        raw = self.buf[self.pos : self.pos + n]
        self.pos += n
        return raw.decode(self.encoding, errors="replace")

    def index(self, size: int, *, vertex: bool) -> int:
        """Vertex indices are unsigned for sizes 1/2; others signed (−1 = none)."""
        if size == 1:
            return self.u8() if vertex else self.i8()
        if size == 2:
            return self.u16() if vertex else self.i16()
        return self.i32()


def parse_pmx(data: bytes) -> PMXModel:
    """Parse a PMX file's bytes."""
    r = _Reader(data)
    model = PMXModel()

    # --- header ---
    if data[:4] not in (b"PMX ", b"PMX\x20"):
        raise ValueError("not a PMX file")
    r.skip(4)
    model.version = r.f32()
    globals_count = r.u8()
    if globals_count < 8:
        raise ValueError(f"invalid PMX globals count {globals_count}")
    g = [r.u8() for _ in range(globals_count)]
    encoding, add_uv, v_sz, tex_sz, mat_sz, bone_sz, morph_sz, rb_sz = g[:8]
    r.encoding = "utf-16-le" if encoding == 0 else "utf-8"
    model.name = r.text()
    model.english_name = r.text()
    model.comment = r.text()
    model.english_comment = r.text()

    # --- vertices ---
    vcount = r.i32()
    positions = np.zeros((vcount, 3), np.float32)
    normals = np.zeros((vcount, 3), np.float32)
    uvs = np.zeros((vcount, 2), np.float32)
    add_uvs = np.zeros((vcount, add_uv, 4), np.float32) if add_uv else None
    deform_types = np.zeros(vcount, np.uint8)
    joints4 = np.zeros((vcount, 4), np.int32)
    weights4 = np.zeros((vcount, 4), np.float32)
    sdef_c = np.zeros((vcount, 3), np.float32)
    sdef_r0 = np.zeros((vcount, 3), np.float32)
    sdef_r1 = np.zeros((vcount, 3), np.float32)
    edge_scale = np.zeros(vcount, np.float32)
    has_sdef = False

    for i in range(vcount):
        positions[i] = r.fvec(3)
        normals[i] = r.fvec(3)
        uvs[i] = r.fvec(2)
        if add_uv:
            for k in range(add_uv):
                add_uvs[i, k] = r.fvec(4)
        dt = r.u8()
        deform_types[i] = dt
        if dt == DEFORM_BDEF1:
            joints4[i, 0] = r.index(bone_sz, vertex=False)
            weights4[i, 0] = 1.0
        elif dt in (DEFORM_BDEF2, DEFORM_SDEF):
            joints4[i, 0] = r.index(bone_sz, vertex=False)
            joints4[i, 1] = r.index(bone_sz, vertex=False)
            w0 = r.f32()
            weights4[i, 0] = w0
            weights4[i, 1] = 1.0 - w0
            if dt == DEFORM_SDEF:
                sdef_c[i] = r.fvec(3)
                sdef_r0[i] = r.fvec(3)
                sdef_r1[i] = r.fvec(3)
                has_sdef = True
        elif dt in (DEFORM_BDEF4, DEFORM_QDEF):
            for k in range(4):
                joints4[i, k] = r.index(bone_sz, vertex=False)
            weights4[i] = r.fvec(4)
        else:
            raise ValueError(f"invalid deform type {dt} at vertex {i}")
        edge_scale[i] = r.f32()

    model.positions = positions
    model.normals = normals
    model.uvs = uvs
    model.additional_uvs = add_uvs
    model.deform_types = deform_types
    model.joints4 = joints4
    model.weights4 = weights4
    if has_sdef:
        model.sdef_c, model.sdef_r0, model.sdef_r1 = sdef_c, sdef_r0, sdef_r1
    model.edge_scale = edge_scale

    return _parse_pmx_tail(r, data, model, v_sz, tex_sz, mat_sz, bone_sz, morph_sz, rb_sz)


def _parse_pmx_tail(
    r: _Reader, data: bytes, model: PMXModel,
    v_sz: int, tex_sz: int, mat_sz: int, bone_sz: int, morph_sz: int, rb_sz: int,
) -> PMXModel:
    # --- indices (vectorized) ---
    icount = r.i32()
    dtype = {1: np.uint8, 2: np.uint16, 4: np.int32}[v_sz]
    model.indices = (
        np.frombuffer(data, dtype, icount, r.pos).astype(np.int32).copy()
    )
    r.skip(icount * v_sz)

    # --- textures ---
    model.textures = [r.text() for _ in range(r.i32())]

    # --- materials ---
    for _ in range(r.i32()):
        name = r.text()
        eng = r.text()
        diffuse = r.fvec(4)
        specular = r.fvec(3)
        shininess = r.f32()
        ambient = r.fvec(3)
        flags = r.u8()
        edge_color = r.fvec(4)
        edge_size = r.f32()
        tex = r.index(tex_sz, vertex=False)
        sphere_tex = r.index(tex_sz, vertex=False)
        sphere_mode = r.u8()
        shared_toon = r.u8() == 1
        toon_tex = r.u8() if shared_toon else r.index(tex_sz, vertex=False)
        comment = r.text()
        index_count = r.i32()
        model.materials.append(
            PMXMaterial(
                name, eng, diffuse, specular, shininess, ambient, flags,
                edge_color, edge_size, tex, sphere_tex, sphere_mode,
                shared_toon, toon_tex, comment, index_count,
            )
        )

    # --- bones ---
    for _ in range(r.i32()):
        name = r.text()
        eng = r.text()
        position = r.fvec(3)
        parent = r.index(bone_sz, vertex=False)
        order = r.i32()
        flags = r.u16()
        bone = PMXBone(name, eng, position, parent, order, flags)
        if flags & FLAG_TAIL_IS_BONE:
            bone.tail_bone = r.index(bone_sz, vertex=False)
        else:
            bone.tail_offset = r.fvec(3)
        if flags & (FLAG_APPEND_ROTATE | FLAG_APPEND_MOVE):
            bone.append_parent = r.index(bone_sz, vertex=False)
            bone.append_ratio = r.f32()
        if flags & FLAG_AXIS_LIMIT:
            bone.axis_limit = r.fvec(3)
        if flags & FLAG_LOCAL_AXIS:
            bone.local_axis_x = r.fvec(3)
            bone.local_axis_z = r.fvec(3)
        if flags & FLAG_EXTERNAL_PARENT:
            bone.external_parent = r.i32()
        if flags & FLAG_IK:
            target = r.index(bone_sz, vertex=False)
            loop = r.i32()
            limit_angle = r.f32()
            links = []
            for _li in range(r.i32()):
                lb = r.index(bone_sz, vertex=False)
                has_limit = r.u8() == 1
                if has_limit:
                    lmin = r.fvec(3)
                    lmax = r.fvec(3)
                else:
                    lmin = np.zeros(3, np.float32)
                    lmax = np.zeros(3, np.float32)
                links.append(PMXIKLink(lb, has_limit, lmin, lmax))
            bone.ik = PMXIK(target, loop, limit_angle, links)
        model.bones.append(bone)

    # --- morphs ---
    for _ in range(r.i32()):
        name = r.text()
        eng = r.text()
        panel = r.u8()
        kind = r.u8()
        n = r.i32()
        morph = PMXMorph(name, eng, panel, kind)
        if kind == 0:  # group
            gi = np.zeros(n, np.int32)
            gr = np.zeros(n, np.float32)
            for k in range(n):
                gi[k] = r.index(morph_sz, vertex=False)
                gr[k] = r.f32()
            morph.group_indices, morph.group_ratios = gi, gr
        elif kind == 1:  # vertex
            vi = np.zeros(n, np.int32)
            vo = np.zeros((n, 3), np.float32)
            for k in range(n):
                vi[k] = r.index(v_sz, vertex=True)
                vo[k] = r.fvec(3)
            morph.vertex_indices, morph.vertex_offsets = vi, vo
        elif kind == 2:  # bone
            bi = np.zeros(n, np.int32)
            bt = np.zeros((n, 3), np.float32)
            br = np.zeros((n, 4), np.float32)
            for k in range(n):
                bi[k] = r.index(bone_sz, vertex=False)
                bt[k] = r.fvec(3)
                br[k] = r.fvec(4)
            morph.bone_indices = bi
            morph.bone_translations = bt
            morph.bone_rotations = br
        elif kind in (3, 4, 5, 6, 7):  # uv
            ui = np.zeros(n, np.int32)
            uo = np.zeros((n, 4), np.float32)
            for k in range(n):
                ui[k] = r.index(v_sz, vertex=True)
                uo[k] = r.fvec(4)
            morph.uv_indices, morph.uv_offsets = ui, uo
        elif kind == 8:  # material morph
            mi = np.zeros(n, np.int32)
            mop = np.zeros(n, np.uint8)  # 0 = multiply, 1 = add
            mdat = np.zeros((n, 28), np.float32)
            for _k in range(n):
                mi[_k] = r.index(mat_sz, vertex=False)
                mop[_k] = r.u8()
                # diffuse4, specular3, shininess, ambient3, edge_color4,
                # edge_size, tex_tint4, env_tint4, toon_tint4
                mdat[_k] = r.fvec(28)
            morph.mat_indices = mi
            morph.mat_ops = mop
            morph.mat_data = mdat
        elif kind == 9:  # flip (PMX 2.1)
            for _k in range(n):
                r.index(morph_sz, vertex=False)
                r.f32()
        elif kind == 10:  # impulse (PMX 2.1)
            for _k in range(n):
                r.index(rb_sz, vertex=False)
                r.u8()
                r.skip(6 * 4)
        else:
            raise ValueError(f"unknown morph kind {kind}")
        model.morphs.append(morph)

    # --- display frames (skipped, cursor advanced) ---
    for _ in range(r.i32()):
        r.text()
        r.text()
        r.u8()
        for _k in range(r.i32()):
            et = r.u8()
            r.index(bone_sz if et == 0 else morph_sz, vertex=False)

    # --- rigid bodies ---
    for _ in range(r.i32()):
        name = r.text()
        eng = r.text()
        bone = r.index(bone_sz, vertex=False)
        group = r.u8()
        mask = r.u16()
        shape = r.u8()
        size = r.fvec(3)
        pos = r.fvec(3)
        rot = r.fvec(3)
        mass = r.f32()
        lin_damp = r.f32()
        ang_damp = r.f32()
        restitution = r.f32()
        friction = r.f32()
        mode = r.u8()
        model.rigid_bodies.append(
            PMXRigidBody(
                name, eng, bone, group, mask, shape, size, pos, rot, mass,
                lin_damp, ang_damp, restitution, friction, mode,
            )
        )

    # --- joints ---
    for _ in range(r.i32()):
        name = r.text()
        eng = r.text()
        kind = r.u8()
        a = r.index(rb_sz, vertex=False)
        b = r.index(rb_sz, vertex=False)
        pos = r.fvec(3)
        rot = r.fvec(3)
        pmin = r.fvec(3)
        pmax = r.fvec(3)
        rmin = r.fvec(3)
        rmax = r.fvec(3)
        spos = r.fvec(3)
        srot = r.fvec(3)
        model.joints.append(
            PMXJoint(name, eng, kind, a, b, pos, rot, pmin, pmax, rmin, rmax, spos, srot)
        )

    return model


def load_pmx(path: str) -> PMXModel:
    with open(path, "rb") as f:
        return parse_pmx(f.read())
