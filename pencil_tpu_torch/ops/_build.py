"""Build and load the kernels of ``csrc/`` with nvcc, at first use.

Each library is one ``csrc/*.cu`` built with its own -D definitions
(``LIBRARIES``: the flagship template's source gives 26, the MHD
instances, the 4-field hydro ones with ``PC_MAG=0``, both with an
entropy field, ``PC_ENT=1``, the MHD and hydro ones with the shock slot,
``PC_SHOCK=1``, on the periodic state, the shear box's on its ghosted
stack, ``PC_SHEAR=1``, MHD or hydro, with or without the shock slot, all
of both with an entropy field too, and the 5- and 8-field entropy
ones with ``PC_ZG=1``, stratified convection and magnetoconvection on the
interior stack and its z-halo slabs, both also with ``PC_SHEAR=1``, the
stratified shearing box on the x/y-ghosted stack and its slabs, or with
``PC_SHOCK=1``, the two with the shock slot, and the same four without
``PC_ENT`` and the slot, the isothermal stratified layer), with a plain C
interface, loaded with ``ctypes``, so a build needs no PyTorch headers and
takes seconds; the libraries are compiled in parallel, one nvcc each, at
most one per CPU, the longest first, in the background (``start``), and
``load`` waits for its own library only.
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
import threading
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
    "fused_rhs_shock": ("fused_rhs.cu", ("-DPC_SHOCK=1",)),
    "fused_rhs_shear": ("fused_rhs.cu", ("-DPC_SHOCK=1", "-DPC_SHEAR=1")),
    # the isothermal layouts of the shock and shear builds: supersonic
    # hydro turbulence, the shear box without the shock slot, and the
    # hydro shear box with and without it
    "fused_rhs_shock_hydro": ("fused_rhs.cu", ("-DPC_MAG=0",
                                               "-DPC_SHOCK=1")),
    "fused_rhs_shear_ns": ("fused_rhs.cu", ("-DPC_SHEAR=1",)),
    "fused_rhs_shear_hydro": ("fused_rhs.cu", ("-DPC_MAG=0", "-DPC_SHOCK=1",
                                               "-DPC_SHEAR=1")),
    "fused_rhs_shear_hydro_ns": ("fused_rhs.cu", ("-DPC_MAG=0",
                                                  "-DPC_SHEAR=1")),
    # the hydro layouts with an entropy field: non-isothermal supersonic
    # turbulence, and the hydro shear box with ss with and without the
    # shock slot
    "fused_rhs_shock_hydro_ent": ("fused_rhs.cu", ("-DPC_MAG=0", "-DPC_ENT=1",
                                                   "-DPC_SHOCK=1")),
    "fused_rhs_shear_hydro_ent": ("fused_rhs.cu", ("-DPC_MAG=0", "-DPC_ENT=1",
                                                   "-DPC_SHOCK=1",
                                                   "-DPC_SHEAR=1")),
    "fused_rhs_shear_hydro_ent_ns": ("fused_rhs.cu", ("-DPC_MAG=0",
                                                      "-DPC_ENT=1",
                                                      "-DPC_SHEAR=1")),
    # the MHD layouts with ss: non-isothermal MHD shock turbulence, and
    # the MHD shear box with ss with and without the shock slot
    "fused_rhs_shock_ent": ("fused_rhs.cu", ("-DPC_ENT=1", "-DPC_SHOCK=1")),
    "fused_rhs_shear_ent": ("fused_rhs.cu", ("-DPC_ENT=1", "-DPC_SHOCK=1",
                                             "-DPC_SHEAR=1")),
    "fused_rhs_shear_ent_ns": ("fused_rhs.cu", ("-DPC_ENT=1",
                                                "-DPC_SHEAR=1")),
    "fused_rhs_zg": ("fused_rhs.cu", ("-DPC_MAG=0", "-DPC_ENT=1",
                                      "-DPC_ZG=1")),
    "fused_rhs_zg_mag": ("fused_rhs.cu", ("-DPC_ENT=1", "-DPC_ZG=1")),
    # the stratified shearing box, hydro and MHD: the z-ghosted builds with
    # the Shear terms on the x/y-ghosted stack
    "fused_rhs_zg_shear": ("fused_rhs.cu", ("-DPC_MAG=0", "-DPC_ENT=1",
                                            "-DPC_ZG=1", "-DPC_SHEAR=1")),
    "fused_rhs_zg_mag_shear": ("fused_rhs.cu", ("-DPC_ENT=1", "-DPC_ZG=1",
                                                "-DPC_SHEAR=1")),
    # the isothermal stratified layer, hydro and MHD, each with and without
    # Shear: the z-ghosted builds without ss, gravity read as g_z(z)
    "fused_rhs_zg_iso": ("fused_rhs.cu", ("-DPC_MAG=0", "-DPC_ZG=1")),
    "fused_rhs_zg_iso_mag": ("fused_rhs.cu", ("-DPC_ZG=1",)),
    "fused_rhs_zg_iso_shear": ("fused_rhs.cu", ("-DPC_MAG=0", "-DPC_ZG=1",
                                                "-DPC_SHEAR=1")),
    "fused_rhs_zg_iso_mag_shear": ("fused_rhs.cu", ("-DPC_ZG=1",
                                                    "-DPC_SHEAR=1")),
    # stratified convection and magnetoconvection with the shock slot: the
    # z-ghosted builds with ss reading the Shock module's profile
    "fused_rhs_zg_shock": ("fused_rhs.cu", ("-DPC_MAG=0", "-DPC_ENT=1",
                                            "-DPC_ZG=1", "-DPC_SHOCK=1")),
    "fused_rhs_zg_mag_shock": ("fused_rhs.cu", ("-DPC_ENT=1", "-DPC_ZG=1",
                                                "-DPC_SHOCK=1")),
}

_p = ctypes.c_void_p
# the flagship template's entry points in its libraries: the shock and
# shear builds have the first and the middle kernel only (K1s and K5w, K4
# and K5, and those of their other layouts), and
# so have the z-ghosted builds (K6 and K7, K6m and K7m), whose two take
# their z-halo slabs and layer profiles after the stream; every entry point
# but K8's takes g_z(z) and the continuous forcing last; K8 (the fake RHS)
# is built for the MHD instances only
_SHOCK = {
    "pc_tile_shape": [_p],
    "pc_flagship_attrs": [ctypes.c_int, _p],
    "pc_rhs_first": [_p] * 7,
    "pc_rhs_tail_mid": [_p] * 9,
}
_FLAGSHIP = {
    **_SHOCK,
    "pc_rhs_tail_defer": [_p] * 9,
    "pc_rhs_tail_last": [_p] * 11,
    "pc_rhs_tail_defer_last": [_p] * 11,
}
_ZG = {**_SHOCK, "pc_rhs_first": [_p] * 11, "pc_rhs_tail_mid": [_p] * 13}
# each library's entry points: name -> argtypes (all return an int)
SIGNATURES = {
    "fused_rhs": {
        **_FLAGSHIP,
        "pc_rhs_first_fake": [_p] * 5,
        "pc_rhs_tail_defer_fake": [_p] * 7,
        "pc_rhs_tail_last_fake": [_p] * 9,
    },
    "fused_rhs_hydro": _FLAGSHIP,
    "fused_rhs_ent": _FLAGSHIP,
    "fused_rhs_hydro_ent": _FLAGSHIP,
    "fused_rhs_shock": _SHOCK,
    "fused_rhs_shear": _SHOCK,
    "fused_rhs_shock_hydro": _SHOCK,
    "fused_rhs_shear_ns": _SHOCK,
    "fused_rhs_shear_hydro": _SHOCK,
    "fused_rhs_shear_hydro_ns": _SHOCK,
    "fused_rhs_shock_hydro_ent": _SHOCK,
    "fused_rhs_shear_hydro_ent": _SHOCK,
    "fused_rhs_shear_hydro_ent_ns": _SHOCK,
    "fused_rhs_shock_ent": _SHOCK,
    "fused_rhs_shear_ent": _SHOCK,
    "fused_rhs_shear_ent_ns": _SHOCK,
    "fused_rhs_zg": _ZG,
    "fused_rhs_zg_mag": _ZG,
    "fused_rhs_zg_shear": _ZG,
    "fused_rhs_zg_mag_shear": _ZG,
    "fused_rhs_zg_iso": _ZG,
    "fused_rhs_zg_iso_mag": _ZG,
    "fused_rhs_zg_iso_shear": _ZG,
    "fused_rhs_zg_iso_mag_shear": _ZG,
    "fused_rhs_zg_shock": _ZG,
    "fused_rhs_zg_mag_shock": _ZG,
}

_libs = {}
_job = None              # the last build started (``start``)
build_seconds = None     # wall time of the last nvcc run, None if cached
build_times = {}         # library -> s from that run's start to its nvcc's end


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


def _nvcc_order() -> list:
    """The libraries in the order their nvcc runs start, the longest first:
    by entry points (the periodic builds' tails), then the z-ghosted
    builds with ss (twelve or, with the shock slot, sixteen instances a
    kernel, the others six), then slots."""
    def key(name):
        defs = LIBRARIES[name][1]
        fields = (4 + 3 * ("-DPC_MAG=0" not in defs) + ("-DPC_ENT=1" in defs)
                  + ("-DPC_SHOCK=1" in defs))
        chi = "-DPC_ZG=1" in defs and "-DPC_ENT=1" in defs
        return len(SIGNATURES[name]), chi, fields
    return sorted(LIBRARIES, key=key, reverse=True)


class _Build:
    """The nvcc runs of the libraries missing when it was made, at most one
    per CPU at a time, the longest first (``_nvcc_order``): the build then
    ends about when its longest run does.  A thread of its own runs them;
    ``done[name]`` is set when ``name``'s run has ended, ``failed[name]``
    then holds its error."""

    def __init__(self):
        self.out = {name: library_path(name) for name in LIBRARIES}
        self.todo = [n for n in _nvcc_order() if not self.out[n].exists()]
        self.done = {name: threading.Event() for name in LIBRARIES}
        for name in LIBRARIES:
            if name not in self.todo:
                self.done[name].set()
        self.failed, self.cancelled = {}, False
        self.thread = threading.Thread(target=self._run, name="nvcc")

    def _run(self):
        global build_seconds
        if not self.todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        todo, running, tmps = list(self.todo), {}, {}
        try:
            while (todo or running) and not self.cancelled:
                while todo and len(running) < (os.cpu_count() or 1):
                    name = todo.pop(0)
                    for ext in (".so", ".log"):
                        fd, tmps[name + ext] = tempfile.mkstemp(
                            suffix=ext, dir=BUILD_DIR)
                        os.close(fd)
                    with open(tmps[name + ".log"], "w") as log:
                        running[name] = subprocess.Popen(
                            [nvcc_path(), *NVCC_FLAGS, *LIBRARIES[name][1],
                             "-o", tmps[name + ".so"], str(sources()[name])],
                            stdout=log, stderr=subprocess.STDOUT)
                time.sleep(0.05)
                for name, proc in list(running.items()):
                    if proc.poll() is None:
                        continue
                    del running[name]
                    build_times[name] = time.perf_counter() - t0
                    log = tmps.pop(name + ".log")
                    if proc.returncode != 0:
                        self.failed[name] = (
                            f"{name} ({sources()[name].name}): nvcc failed "
                            f"({proc.returncode}):\n{Path(log).read_text()}")
                    else:
                        os.replace(tmps[name + ".so"], self.out[name])
                    for tmp in (log, tmps.pop(name + ".so")):
                        if os.path.exists(tmp):
                            os.unlink(tmp)
                    self.done[name].set()
        except Exception as e:          # nvcc not found, a full disk, ...
            for name in self.todo:
                if not self.done[name].is_set():
                    self.failed[name] = f"{name}: {e!r}"
        finally:
            for proc in running.values():
                proc.kill()
                proc.wait()
            for tmp in tmps.values():
                if os.path.exists(tmp):
                    os.unlink(tmp)
            for name in self.todo:
                if not self.done[name].is_set():
                    self.failed.setdefault(name, f"{name}: build cancelled")
                    self.done[name].set()
        build_seconds = time.perf_counter() - t0


def start():
    """Start compiling every missing library in the background, unless a
    build is running; returns at once.  ``load`` waits for its library
    alone, so a caller can use the first ones built while the rest
    compile."""
    global _job
    if _job is None or not _job.thread.is_alive():
        _job = _Build()
        _job.thread.start()
    return _job


def cancel():
    """Stop the running build, if any: its nvcc runs are killed."""
    if _job is not None and _job.thread.is_alive():
        _job.cancelled = True
        _job.thread.join()


def _wait(job, names):
    for name in names:
        job.done[name].wait()
    errors = [job.failed[name] for name in names if name in job.failed]
    if errors:
        raise RuntimeError("\n".join(errors))


def build() -> dict:
    """Compile every library that is missing (``start``) and wait for all
    of them; returns name -> library path."""
    job = start()
    _wait(job, list(LIBRARIES))
    return job.out


def load(name: str = "fused_rhs"):
    """The loaded library ``name`` with every entry point's ctypes
    signature set."""
    if name not in _libs:
        job = start() if _job is None or name in _job.failed else _job
        _wait(job, [name])
        lib = ctypes.CDLL(str(job.out[name]))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
