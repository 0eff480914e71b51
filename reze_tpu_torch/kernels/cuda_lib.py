"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use ``nvcc`` compiles every ``.cu`` file under ``csrc/`` for
``sm_90a`` (one compiler process per file, all started together) and
links the objects into one shared library with a plain C interface, in
``<checkout>/build/kernels-<hash of the sources and flags>/``, loaded
with ctypes. A later call in any process finds the library by its hash and
only loads it. Nothing here runs at import time.

``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into fused
multiply-adds, so every product rounds on its own as in the plain torch
versions the kernels are checked against (edge/depth planes decide
coverage and z-ties; a one-ulp difference flips pixels).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry points and their argument types (pointers and the stream as
# c_void_p so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "reze_frame": [_P, _L, _P, _P,  # rows, rows_stride, starts, counts
                   _P, _I, _P, _I, _I, _P, _I,  # knot, kr, tex, kt, tex_cols, edge, ke
                   _P, _P, _P, _P,  # ldir, lcol, misc, inv_vp
                   _P, _I, _I, _I, _I, _I,  # out, hp, wp, n_samples, analytic, n_levels
                   _I, _P],  # n_chars, stream
    "reze_frame_hybrid": [_P, _L, _P, _P,  # rows, rows_stride, starts, counts
                          _P, _I, _P, _I, _I, _P, _I,  # knot, kr, tex, kt, tex_cols, edge, ke
                          _P, _P, _P, _P,  # ldir, lcol, misc, inv_vp
                          _P, _I, _I, _I, _I, _I,  # out, hp, wp, n_samples, analytic, n_levels
                          _I, _P],  # n_chars, stream
    "reze_frame_mxu": [_P, _P, _P,  # rows, starts, counts
                       _P, _I, _I, _I, _P],  # out, hp, wp, n_samples, stream
    "reze_frame_stream": [_P, _L, _P,  # rows, rows_stride, bounds
                          _P, _I, _I, _I, _I, _P],  # out, hp, wp, n_samples, n_chars, stream
    "reze_composite": [_P, _P, _L, _I, _P, _P,  # o, atlas, n_texels, quad, img, half
                       _I, _I, _I, _I, _I,  # hp, wp, half0, half1, with_bloom
                       _I, _P],  # n_chars, stream
    "reze_raster": [_P, _P, _I, _P, _P,  # tab, ids, n_ids, starts, counts
                    _P, _P, _I, _I,  # zbuf (in place), gbuf, hp, wp
                    _I, _I, _I, _P],  # n_samples, depth_write, with_attrs, stream
    "reze_shade_stack": [_P,  # stack
                         _P, _I, _P, _I, _I, _P, _I,  # knot, kr, tex, kt, tex_cols, edge, ke
                         _P, _P, _P, _P,  # ldir, lcol, misc, inv_vp
                         _P, _I, _I, _I,  # out, hp, wp, n_levels
                         _I, _P],  # n_chars, stream
}

_lib = None
build_seconds = None  # wall time of the last build (None: loaded, not built)
build_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"
    so = out_dir / "libreze_kernels.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag, t0 = _nvcc(), f"tmp-{os.getpid()}", time.perf_counter()
        cus = [p for p in sources if p.suffix == ".cu"]
        objs = [str(out_dir / f"{p.stem}.{tag}.o") for p in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)], text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for p, o in zip(cus, objs)]
        build_log = "".join(p.communicate()[0] for p in procs)
        tmp = out_dir / f"{tag}.so"
        ok = not any(p.returncode for p in procs)
        if ok:  # link the objects into one library
            res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs], text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            build_log, ok = build_log + res.stdout, res.returncode == 0
        if not ok:
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, so)
        for o in objs:
            os.unlink(o)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
