"""ctypes bindings of the native asset parsers (``csrc/reze_native.cpp``;
counterpart of ``reze_tpu/formats/native.py``).

At first use g++ builds the source into
``<checkout>/build/native-<hash of the source and flags>/``, which a later
process finds by its hash and only loads. A failed build raises with the
compiler's output: the parsers never fall back to Python on their own.
Each entry point returns None for a block the native code refuses (a
result of -1), and the caller then runs its pure-Python parse, which
raises on it. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "reze_native.cpp"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None


def library() -> ctypes.CDLL:
    """The loaded parser library, built first if its source changed."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / f"native-{h.hexdigest()[:16]}"
    so = out_dir / "libreze_native.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"tmp-{os.getpid()}.so"
        try:
            res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        except OSError as e:
            raise RuntimeError(f"g++ could not run to build {SOURCE.name}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{res.stdout}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.reze_parse_pmx_vertices.restype = ctypes.c_longlong
    lib.reze_parse_vmd_bone_frames.restype = ctypes.c_longlong
    _lib = lib
    return lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def parse_pmx_vertices(
    data: bytes, offset: int, vertex_count: int, add_uv_count: int, bone_index_size: int
):
    """The PMX vertex block at ``offset`` -> a dict of arrays and the end
    offset, or None where the native parser refuses the block."""
    lib = library()
    n = max(vertex_count, 0)
    positions = np.empty((n, 3), np.float32)
    normals = np.empty((n, 3), np.float32)
    uvs = np.empty((n, 2), np.float32)
    add_uvs = np.zeros((n, max(add_uv_count, 1), 4), np.float32)
    deform_types = np.empty(n, np.uint8)
    joints = np.empty((n, 4), np.int32)
    weights = np.empty((n, 4), np.float32)
    sdef_c = np.zeros((n, 3), np.float32)
    sdef_r0 = np.zeros((n, 3), np.float32)
    sdef_r1 = np.zeros((n, 3), np.float32)
    edge_scale = np.empty(n, np.float32)
    has_sdef = ctypes.c_int(0)
    buf = np.frombuffer(data, np.uint8)
    end = lib.reze_parse_pmx_vertices(
        _ptr(buf), ctypes.c_longlong(len(data)), ctypes.c_longlong(offset),
        n, add_uv_count, bone_index_size,
        _ptr(positions), _ptr(normals), _ptr(uvs), _ptr(add_uvs),
        _ptr(deform_types), _ptr(joints), _ptr(weights),
        _ptr(sdef_c), _ptr(sdef_r0), _ptr(sdef_r1), _ptr(edge_scale),
        ctypes.byref(has_sdef),
    )
    if end < 0:
        return None
    return {
        "positions": positions,
        "normals": normals,
        "uvs": uvs,
        "additional_uvs": add_uvs if add_uv_count else None,
        "deform_types": deform_types,
        "joints4": joints,
        "weights4": weights,
        "sdef": (sdef_c, sdef_r0, sdef_r1) if has_sdef.value else None,
        "edge_scale": edge_scale,
        "end": int(end),
    }


def parse_vmd_bone_frames(data: bytes, offset: int, n: int):
    """``n`` VMD bone frames at ``offset`` -> a dict of columns and the end
    offset, or None where the block runs past the data."""
    lib = library()
    n = max(n, 0)
    names = np.empty((n, 15), np.uint8)
    frames = np.empty(n, np.uint32)
    positions = np.empty((n, 3), np.float32)
    rotations = np.empty((n, 4), np.float32)
    interp = np.empty((n, 16), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    end = lib.reze_parse_vmd_bone_frames(
        _ptr(buf), ctypes.c_longlong(len(data)), ctypes.c_longlong(offset),
        n, _ptr(names), _ptr(frames), _ptr(positions), _ptr(rotations), _ptr(interp),
    )
    if end < 0:
        return None
    return {
        "names": names,
        "frames": frames,
        "positions": positions,
        "rotations": rotations,
        "interp": interp,
        "end": int(end),
    }
