"""Build and load ``csrc/fused_rhs.cu`` with nvcc, at first use.

The shared library has a plain C interface and is loaded with ``ctypes``,
so the build needs no PyTorch headers and takes seconds.  It lands in
``pencil_tpu_torch/_build/`` (git-ignored), keyed by a hash of the source
and the flags, so an edited source rebuilds.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_rhs.cu"
BUILD_DIR = _PKG / "_build"
# no --use_fast_math: the 2e-5 parity bound needs full-precision sincosf,
# expf, sqrtf and division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None
build_seconds = None     # wall time of the last nvcc run, None if cached


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"fused_rhs_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for this source exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return out


def load():
    """The loaded library with every entry point's ctypes signature set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p = ctypes.c_void_p
        sigs = {
            "pc_tile_shape": [p],
            "pc_rhs_first": [p, p, p, p, p],
            "pc_rhs_tail_defer": [p, p, p, p, p, p, p],
            "pc_rhs_tail_last": [p, p, p, p, p, p, p, p],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
