"""File writers for the benchmark's scenes (a frozen copy of the port's
``testing`` writers and PNG encoder): PMX 2.0/2.1, VMD, PNG, 24/32-bit
BMP and TGA, in the byte layouts the port's loaders read."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..reference.formats.image import _PNG_MAGIC
from ..reference.formats.pmx import (
    DEFORM_BDEF1,
    DEFORM_BDEF2,
    DEFORM_SDEF,
    FLAG_APPEND_MOVE,
    FLAG_APPEND_ROTATE,
    FLAG_AXIS_LIMIT,
    FLAG_EXTERNAL_PARENT,
    FLAG_IK,
    FLAG_LOCAL_AXIS,
    FLAG_TAIL_IS_BONE,
    PMXModel,
)
from ..reference.formats.vmd import VMDMotion


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, filters=None, palette=None, transparency=None) -> bytes:
    """An 8-bit PNG of ``img``: (h, w) grey, (h, w, 2) grey and alpha, (h,
    w, 3) RGB or (h, w, 4) RGBA; with ``palette`` ((n, 3) uint8), (h, w)
    palette indices. ``filters``: the row filter of each row (0-4),
    cycled; every filter in turn by default. ``transparency``: the bytes
    of a ``tRNS`` chunk."""
    img = np.asarray(img, np.uint8)
    if palette is not None:
        ctype, px = 3, img[..., None]
    else:
        px = img if img.ndim == 3 else img[..., None]
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[px.shape[2]]
    h, w, bpp = px.shape
    cur = px.reshape(h, w * bpp).astype(np.int64)
    prev = np.vstack([np.zeros((1, w * bpp), np.int64), cur[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int64), cur[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int64), prev[:, :-bpp]])
    p = left + prev - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    preds = [np.zeros_like(cur), left, prev, (left + prev) >> 1, paeth]
    filters = list(filters) if filters is not None else [0, 1, 2, 3, 4]
    raw = bytearray()
    for y in range(h):
        ft = filters[y % len(filters)]
        raw.append(ft)
        raw += ((cur[y] - preds[ft][y]) & 255).astype(np.uint8).tobytes()
    body = [_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    if palette is not None:
        body.append(_png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if transparency is not None:
        body.append(_png_chunk(b"tRNS", bytes(transparency)))
    body.append(_png_chunk(b"IDAT", zlib.compress(bytes(raw))))
    body.append(_png_chunk(b"IEND", b""))
    return _PNG_MAGIC + b"".join(body)


def write_png(path: str, img: np.ndarray, **kw) -> None:
    """:func:`encode_png` of ``img`` into the file ``path``."""
    data = encode_png(img, **kw)
    with open(path, "wb") as f:
        f.write(data)


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

