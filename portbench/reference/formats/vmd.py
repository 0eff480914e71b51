"""VMD (Vocaloid Motion Data) animation parser (counterpart of
``reze_tpu/formats/vmd.py``).

Parses the whole format: bone frames with their translations and 64-byte
Bezier blocks, morph frames and camera frames, in Python alone (a frozen
copy of the port's ``formats/vmd.py`` without its native parser). VMD
stores frame numbers at 30 FPS.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


FRAME_RATE = 30.0

_HEADER_MAGIC = b"Vocaloid Motion Data"


def _decode_sjis(raw: bytes) -> str:
    raw = raw.split(b"\x00", 1)[0]
    try:
        return raw.decode("shift_jis")
    except UnicodeDecodeError:
        return raw.decode("shift_jis", errors="replace")


@dataclass
class VMDMotion:
    """Raw parsed VMD records (unsorted, as stored on disk)."""

    model_name: str = ""
    # bone keyframes
    bone_names: list[str] = field(default_factory=list)  # (N,)
    bone_frames: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    bone_positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    bone_rotations: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))
    # Bezier control points per channel [X, Y, Z, R]: (N, 4, 4) = (x1, y1, x2, y2) in 0..1
    bone_interp: np.ndarray = field(default_factory=lambda: np.zeros((0, 4, 4), np.float32))
    # morph keyframes
    morph_names: list[str] = field(default_factory=list)
    morph_frames: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    morph_weights: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    # camera keyframes
    camera_frames: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    camera_distance: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    camera_position: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    camera_rotation: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    camera_fov: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))

    def duration_seconds(self) -> float:
        best = 0
        if self.bone_frames.size:
            best = max(best, int(self.bone_frames.max()))
        if self.morph_frames.size:
            best = max(best, int(self.morph_frames.max()))
        return best / FRAME_RATE

    def grouped_bone_tracks(self) -> dict[str, dict[str, np.ndarray]]:
        """Group bone keyframes by bone name, sorted by frame number.

        Returns ``{name: {"t": (n,) seconds, "rot": (n,4), "pos": (n,3),
        "interp": (n,4,4)}}``.
        """
        out: dict[str, dict[str, np.ndarray]] = {}
        names = np.asarray(self.bone_names)
        for name in dict.fromkeys(self.bone_names):  # preserves order, dedups
            sel = np.nonzero(names == name)[0]
            order = np.argsort(self.bone_frames[sel], kind="stable")
            sel = sel[order]
            out[name] = {
                "t": (self.bone_frames[sel] / FRAME_RATE).astype(np.float32),
                "rot": self.bone_rotations[sel],
                "pos": self.bone_positions[sel],
                "interp": self.bone_interp[sel],
            }
        return out

    def grouped_morph_tracks(self) -> dict[str, dict[str, np.ndarray]]:
        out: dict[str, dict[str, np.ndarray]] = {}
        names = np.asarray(self.morph_names) if self.morph_names else np.zeros(0)
        for name in dict.fromkeys(self.morph_names):
            sel = np.nonzero(names == name)[0]
            order = np.argsort(self.morph_frames[sel], kind="stable")
            sel = sel[order]
            out[name] = {
                "t": (self.morph_frames[sel] / FRAME_RATE).astype(np.float32),
                "w": self.morph_weights[sel],
            }
        return out


def parse_vmd(data: bytes) -> VMDMotion:
    """Parse a VMD file's bytes."""
    if not data[:30].startswith(_HEADER_MAGIC):
        raise ValueError("invalid VMD header")
    pos = 30
    motion = VMDMotion(model_name=_decode_sjis(data[pos : pos + 20]))
    pos += 20

    # --- bone frames (111 bytes each) ---
    (n,) = struct.unpack_from("<I", data, pos)
    pos += 4
    names: list[str] = []
    frames = np.zeros(n, np.int64)
    positions = np.zeros((n, 3), np.float32)
    rotations = np.zeros((n, 4), np.float32)
    interp = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        names.append(_decode_sjis(data[pos : pos + 15]))
        frame, px, py, pz, rx, ry, rz, rw = struct.unpack_from("<I7f", data, pos + 15)
        frames[i] = frame
        positions[i] = (px, py, pz)
        rotations[i] = (rx, ry, rz, rw)
        # 64-byte block; first 16 bytes hold (x1[XYZR], y1[XYZR], x2[XYZR],
        # y2[XYZR]); remaining 48 are byte-shifted duplicates.
        block = np.frombuffer(data, np.uint8, 16, pos + 47).astype(np.float32) / 127.0
        # rearrange to per-channel (x1, y1, x2, y2)
        interp[i] = block.reshape(4, 4).T
        pos += 111
    motion.bone_names = names
    motion.bone_frames = frames
    motion.bone_positions = positions
    motion.bone_rotations = rotations
    motion.bone_interp = interp
    return _parse_vmd_tail(data, pos, motion)


def _parse_vmd_tail(data: bytes, pos: int, motion: VMDMotion) -> VMDMotion:
    # --- morph frames (23 bytes each) ---
    if pos + 4 <= len(data):
        (n,) = struct.unpack_from("<I", data, pos)
        pos += 4
        mnames: list[str] = []
        mframes = np.zeros(n, np.int64)
        mweights = np.zeros(n, np.float32)
        for i in range(n):
            mnames.append(_decode_sjis(data[pos : pos + 15]))
            frame, w = struct.unpack_from("<If", data, pos + 15)
            mframes[i] = frame
            mweights[i] = w
            pos += 23
        motion.morph_names = mnames
        motion.morph_frames = mframes
        motion.morph_weights = mweights

    # --- camera frames (61 bytes each) ---
    if pos + 4 <= len(data):
        (n,) = struct.unpack_from("<I", data, pos)
        pos += 4
        cframes = np.zeros(n, np.int64)
        cdist = np.zeros(n, np.float32)
        cpos = np.zeros((n, 3), np.float32)
        crot = np.zeros((n, 3), np.float32)
        cfov = np.zeros(n, np.float32)
        for i in range(n):
            frame, dist, px, py, pz, rx, ry, rz = struct.unpack_from("<I7f", data, pos)
            (fov,) = struct.unpack_from("<I", data, pos + 56)
            cframes[i] = frame
            cdist[i] = dist
            cpos[i] = (px, py, pz)
            crot[i] = (rx, ry, rz)
            cfov[i] = fov
            pos += 61
        motion.camera_frames = cframes
        motion.camera_distance = cdist
        motion.camera_position = cpos
        motion.camera_rotation = crot
        motion.camera_fov = cfov

    return motion


def load_vmd(path: str) -> VMDMotion:
    with open(path, "rb") as f:
        return parse_vmd(f.read())
