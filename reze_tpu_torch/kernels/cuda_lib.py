"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use ``nvcc`` compiles every ``.cu`` file under ``csrc/`` into one
shared library with a plain C interface for ``sm_90a``, in
``<checkout>/build/kernels-<hash of the sources and flags>/``, and loads it
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
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry points and their argument types (pointers and the stream as
# c_void_p so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "reze_frame": [_P, _P, _P,  # rows, starts, counts
                   _P, _I, _P, _I, _I, _P, _I,  # knot, kr, tex, kt, tex_cols, edge, ke
                   _P, _P, _P, _P,  # ldir, lcol, misc, inv_vp
                   _P, _I, _I, _I, _I, _I,  # out, hp, wp, n_samples, analytic, n_levels
                   _P],  # stream
    "reze_composite": [_P, _P, _L, _P, _P,  # o, atlas, n_texels, img, half
                       _I, _I, _I, _I, _I,  # hp, wp, half0, half1, with_bloom
                       _P],  # stream
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
        tmp = out_dir / f"tmp-{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(p) for p in sources if p.suffix == ".cu"]]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, so)
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
