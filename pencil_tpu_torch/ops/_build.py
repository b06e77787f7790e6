"""Build and load the kernels of ``csrc/`` with nvcc, at first use.

Each library is one ``csrc/*.cu`` built with its own -D definitions
(``LIBRARIES``: the flagship template's source gives four, the MHD
instances, the 4-field hydro ones with ``PC_MAG=0``, and both with an
entropy field, ``PC_ENT=1``), with a plain C
interface, loaded with ``ctypes``, so a build needs no PyTorch headers and
takes seconds; the libraries are compiled in parallel, one nvcc each.
They land in ``pencil_tpu_torch/_build/`` (git-ignored), keyed by a hash
of the source, the shared headers (``csrc/*.cuh``), the flags and the
definitions, so an edited source rebuilds.  Nothing here runs at import.
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
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# no --use_fast_math: the 2e-5 parity bound needs full-precision sincosf,
# expf, sqrtf and division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# each library: its source in csrc/ and the -D definitions it is built with
LIBRARIES = {
    "fused_rhs": ("fused_rhs.cu", ()),
    "fused_rhs_hydro": ("fused_rhs.cu", ("-DPC_MAG=0",)),
    "fused_rhs_ent": ("fused_rhs.cu", ("-DPC_ENT=1",)),
    "fused_rhs_hydro_ent": ("fused_rhs.cu", ("-DPC_MAG=0", "-DPC_ENT=1")),
    "zghost_rhs": ("zghost_rhs.cu", ()),
    "zroll_rhs": ("zroll_rhs.cu", ()),
}

_p = ctypes.c_void_p
# the flagship template's entry points in both of its libraries; K8 (the
# fake RHS) is built for the MHD instances only
_FLAGSHIP = {
    "pc_tile_shape": [_p],
    "pc_flagship_attrs": [ctypes.c_int, _p],
    "pc_rhs_first": [_p] * 5,
    "pc_rhs_tail_defer": [_p] * 7,
    "pc_rhs_tail_last": [_p] * 8,
    "pc_rhs_tail_mid": [_p] * 7,
    "pc_rhs_tail_defer_last": [_p] * 8,
}
# each library's entry points: name -> argtypes (all return an int)
SIGNATURES = {
    "fused_rhs": {
        **_FLAGSHIP,
        "pc_rhs_first_fake": [_p] * 5,
        "pc_rhs_tail_defer_fake": [_p] * 7,
        "pc_rhs_tail_last_fake": [_p] * 8,
    },
    "fused_rhs_hydro": _FLAGSHIP,
    "fused_rhs_ent": _FLAGSHIP,
    "fused_rhs_hydro_ent": _FLAGSHIP,
    "zghost_rhs": {
        "pc_zg_tile_shape": [_p],
        "pc_rhs_zg": [_p] * 7,
        "pc_rhs_zg_upd": [_p] * 9,
    },
    "zroll_rhs": {
        "pc_zr_tile_shape": [_p],
        "pc_rhs_zroll": [_p] * 5,
        "pc_rhs_zroll_upd": [_p] * 7,
        "pc_rhs_wrap_shock": [_p] * 5,
        "pc_rhs_wrap_shock_upd": [_p] * 7,
    },
}

_libs = {}
build_seconds = None     # wall time of the last nvcc run, None if cached


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources():
    """Library name -> the path of its source."""
    return {name: CSRC / src for name, (src, _) in LIBRARIES.items()}


def library_path(name: str) -> Path:
    h = hashlib.sha256(sources()[name].read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LIBRARIES[name][1]).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every library that is missing, all nvcc runs at once;
    returns name -> library path."""
    global build_seconds
    out = {name: library_path(name) for name in LIBRARIES}
    todo = {name: path for name, path in out.items() if not path.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs, tmps = {}, {}
    try:
        for name in todo:
            fd, tmps[name] = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, *LIBRARIES[name][1], "-o",
                 tmps[name], str(sources()[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        failed = []
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} ({sources()[name].name}): nvcc "
                              f"failed ({proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, path in todo.items():
            os.replace(tmps[name], path)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in tmps.values():
            if os.path.exists(tmp):
                os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return out


def load(name: str = "fused_rhs"):
    """The loaded library ``name`` with every entry point's ctypes
    signature set."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build()[name]))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
