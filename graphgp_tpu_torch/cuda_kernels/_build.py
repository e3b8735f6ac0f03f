"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled for ``sm_90a`` by its own ``nvcc``,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. The build happens at first
use, from the sources in the checkout, into ``graphgp_tpu_torch/_build/``
(listed in ``.gitignore``); the library's file name carries a hash of every
source and header (``csrc/*.cu``, ``csrc/*.cuh``) and the flags, so an
edited file is rebuilt.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def _sources():
    """The sources nvcc compiles, sorted."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _hashed_files():
    """Every file the library is built from: the sources and their headers."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    found = candidate if os.path.exists(candidate) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> str:
    h = hashlib.md5()
    for src in _hashed_files():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgraphgp_kernels_{h.hexdigest()[:12]}.so")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    u32, f32 = ctypes.c_uint32, ctypes.c_float
    lib.stencil_matvec_f32.argtypes = [p, p, p, p, i, i, i, i, ll, i, ll, p]
    lib.stencil_matvec_f32.restype = i
    lib.stencil_dw_f32.argtypes = [p, p, p, p, i, i, i, ll, i, ll, p]
    lib.stencil_dw_f32.restype = i
    lib.ell_to_stencil_f32.argtypes = [p, p, p, p, i, ll, i, i, p]
    lib.ell_to_stencil_f32.restype = i
    lib.gram_rmv_mask_f32.argtypes = [p, p, p, p, p, i, i, i, i, ll, i, ll, p]
    lib.gram_rmv_mask_f32.restype = i
    lib.gram_mv_epilogue_f32.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, ll, i, ll, p]
    lib.gram_mv_epilogue_f32.restype = i
    lib.gram_num_blocks.argtypes = [i, ll]
    lib.gram_num_blocks.restype = i
    lib.walk_step_matrices_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, u32, u32, f32, f32, i, p]
    lib.walk_step_matrices_f32.restype = i
    lib.kernels_error_string.argtypes = [i]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def _compile(path: str) -> str:
    """Build the library at ``path``: one ``nvcc -c`` per source, all running
    at once, then one link. Returns nvcc's output (ptxas's ``-v`` lines);
    raises if a step fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f"{path}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = []
    for i, src in enumerate(_sources()):
        cmd = [_nvcc(), *compile_flags, "-c", "-o", f"{stem}.{i}.o", src]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, proc in procs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"nvcc failed (rc={proc.returncode}):\n{' '.join(cmd)}\n{logs[-1]}")
    objects = [f"{stem}.{i}.o" for i in range(len(procs))]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [_nvcc(), "-shared", "-o", f"{stem}.tmp", *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc={proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{logs[-1]}")
        os.replace(f"{stem}.tmp", path)
    finally:
        for leftover in (*objects, f"{stem}.tmp"):
            if os.path.exists(leftover):
                os.remove(leftover)
    return "".join(logs)


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (one ``nvcc`` per source, in
    parallel)."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        t0 = time.perf_counter()
        build_log = _compile(path)
        build_seconds = time.perf_counter() - t0
    _lib = _declare(ctypes.CDLL(path))
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = _lib.kernels_error_string(rc).decode() if _lib is not None else ""
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
