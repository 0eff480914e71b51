"""The benchmark's seeded scene: a frozen copy of the port's
``testing.make_pmx_spec`` and ``write_scene``, so that a later change to
the port's test helpers cannot move the yardstick.

``make_pmx_spec(seed, "flagship")`` makes a humanoid PMX at the flagship
model's widths (28,842 vertices, 19 materials, 349 bones, 72 morphs, 257
rigid bodies, 406 joints), its textures and a clip; ``"small"`` makes the
CPU tests' model. One change from the port's generator: the clip lasts
``CLIP_FRAMES`` VMD frames (30 s at 30 fps) instead of 60, with keys as
dense as there (core bones every 10 frames, morphs every 15, the camera
every 30), so that no run of the benchmark reaches its end and a frame's
work does not depend on how fast the port runs.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..reference.formats.pmx import (
    DEFORM_BDEF1,
    DEFORM_BDEF2,
    DEFORM_BDEF4,
    DEFORM_QDEF,
    DEFORM_SDEF,
    FLAG_APPEND_MOVE,
    FLAG_APPEND_ROTATE,
    FLAG_AXIS_LIMIT,
    FLAG_EXTERNAL_PARENT,
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
from ..reference.formats.vmd import VMDMotion
from .writers import write_bmp, write_png, write_pmx, write_tga, write_vmd

# the clip's length in VMD frames (30 fps): 30 s, BASELINE config 2's
CLIP_FRAMES = 900


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
    """A seeded humanoid PMX with its textures and a 30 s, 30 fps clip, in
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
    """A clip of ``CLIP_FRAMES`` frames keying the core bones every 10
    frames (rotations up to 0.3 rad, translations on the centre and the leg
    IK within the legs' reach, seeded Bezier easing), morphs every 15
    frames and the camera every 30, in shuffled record order, with a bone
    and a morph the model lacks."""
    names = [n for n in ("センター", "上半身", "上半身2", "首", "頭", "左腕", "右腕", "左ひじ",
                         "右ひじ", "下半身", "左足ＩＫ", "右足ＩＫ", "左肩", "右肩", "両目")
             if n in at] + ["存在しない"]
    frames = np.arange(0, CLIP_FRAMES + 1, 10)
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
    mframes = np.arange(0, CLIP_FRAMES + 1, 15)
    m = len(morph_names) * mframes.size
    morder = rng.permutation(m)
    cframes = np.arange(0, CLIP_FRAMES + 1, 30)[::-1].copy()
    k = cframes.size
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
        camera_distance=-rng.uniform(22, 26, k).astype(np.float32),
        camera_position=np.stack([rng.uniform(-0.5, 0.5, k), rng.uniform(10, 11, k),
                                  rng.uniform(-0.5, 0.5, k)], 1).astype(np.float32),
        camera_rotation=(rng.uniform(-1, 1, (k, 3)) * (0.1, 0.4, 0.05)).astype(np.float32),
        camera_fov=rng.integers(40, 50, k).astype(np.float32))


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

