"""Reference var.dat / dim.dat interop (the port's copy of
``pencil_tpu/compat/io_dist.py``; reference ``src/io_dist.f90``
output_snap :110-167, ``wdim``; read contract used by
python/pencil/read/varfile.py and the IDL readers).

The codec is the C++ one of the repository, ``native/pc_io.cc``, compiled
with g++ at first use into ``pencil_tpu_torch/_build/`` (git-ignored,
keyed by a hash of the source), never into ``native/``; its plain version
is the numpy reader and writer below, which also serve where no compiler
or source is at hand.  Both give the port's C-order (nv, mx, my, mz)
layout.  ``export_state`` writes a port state as a reference data
directory: the ghost zones padded by wrapping on every axis, as the JAX
package writes them (io_dist.py:240), a non-periodic z included.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG.parent / "native" / "pc_io.cc"
_BUILD_DIR = _PKG / "_build"
_GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_LIB = None
_LIB_TRIED = False


def _build_native() -> Optional[Path]:
    """The codec's shared library under ``_build/``, compiled when its
    source hash is new; None without the source or a compiler."""
    if not _SOURCE.exists():
        return None
    h = hashlib.sha256(_SOURCE.read_bytes()
                       + " ".join(_GXX_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libpc_io-{h}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_GXX_FLAGS, "-o", tmp, str(_SOURCE),
                        "-lpthread"], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, out)       # atomic: concurrent builds agree
        return out
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def native_lib():
    """Load (building if needed) the C++ codec; None if unavailable."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = _build_native()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.pc_read_var.restype = ctypes.c_int
    lib.pc_write_var.restype = ctypes.c_int
    lib.pc_io_last_error.restype = ctypes.c_char_p
    _LIB = lib
    return lib


@dataclass
class VarFile:
    f: np.ndarray        # (nv, mx, my, mz) ghosted, C-order
    t: float
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    dx: float
    dy: float
    dz: float
    deltay: Optional[float] = None


def write_dim(path, mx, my, mz, mvar, maux=0, mglobal=0, precision="S",
              nghost=3, nproc=(1, 1, 1), iproc=None):
    """dim.dat writer (reference wdim; parsed by python/pencil/read/dims.py).
    Global file: last line is nprocx nprocy nprocz iprocz_slowest; per-proc
    files (iproc given) end with ipx ipy ipz instead."""
    with open(path, "w") as f:
        f.write(f"{mx:8d}{my:8d}{mz:8d}{mvar:8d}{maux:8d}{mglobal:8d}\n")
        f.write(f"{precision}\n")
        f.write(f"{nghost:4d}{nghost:4d}{nghost:4d}\n")
        if iproc is None:
            f.write(f"{nproc[0]:4d}{nproc[1]:4d}{nproc[2]:4d}{1:4d}\n")
        else:
            f.write(f"{iproc[0]:4d}{iproc[1]:4d}{iproc[2]:4d}\n")


def _records(path, recs):
    """Write ``recs`` as Fortran unformatted sequential records."""
    with open(path, "wb") as f:
        for rec in recs:
            ln = np.uint32(rec.nbytes)
            f.write(ln.tobytes())
            f.write(rec.tobytes())
            f.write(ln.tobytes())


def write_grid(path, x, y, z, dxyz, Lxyz, dx_1=None, dx_tilde=None, t=0.0,
               dtype=np.float32):
    """grid.dat writer (reference wgrid; layout per
    python/pencil/read/grids.py:180-199: records [t,x,y,z], [dx,dy,dz],
    [Lx,Ly,Lz], [dx_1,dy_1,dz_1], [dx_tilde,dy_tilde,dz_tilde])."""
    x = np.asarray(x, dtype)
    y = np.asarray(y, dtype)
    z = np.asarray(z, dtype)
    if dx_1 is None:
        dx_1 = np.concatenate([np.full_like(x, 1.0 / dxyz[0]),
                               np.full_like(y, 1.0 / dxyz[1]),
                               np.full_like(z, 1.0 / dxyz[2])])
    if dx_tilde is None:
        dx_tilde = np.zeros(len(x) + len(y) + len(z), dtype)
    _records(path, [
        np.concatenate([np.asarray([t], dtype), x, y, z]),
        np.asarray(dxyz, dtype),
        np.asarray(Lxyz, dtype),
        np.asarray(dx_1, dtype),
        np.asarray(dx_tilde, dtype),
    ])


def read_dim(path):
    with open(path) as f:
        first = f.readline().split()
        mx, my, mz, mvar, maux = (int(v) for v in first[:5])
        mglobal = int(first[5]) if len(first) > 5 else 0
        precision = f.readline().strip()
        gh = f.readline().split()
        nghost = int(gh[0])
        pr = f.readline().split()
        nproc = tuple(int(v) for v in pr[:3]) if len(pr) >= 3 else (1, 1, 1)
    return dict(mx=mx, my=my, mz=mz, mvar=mvar, maux=maux, mglobal=mglobal,
                precision=precision, nghost=nghost, nproc=nproc)


def np_read_var(path, mx, my, mz, nv, dtype) -> VarFile:
    """The numpy reader: the codec's plain version."""
    with open(path, "rb") as f:
        raw = f.read()
    off = 0

    def rec():
        nonlocal off
        (ln,) = np.frombuffer(raw, np.uint32, 1, off)
        payload = raw[off + 4: off + 4 + ln]
        (tail,) = np.frombuffer(raw, np.uint32, 1, off + 4 + ln)
        if tail != ln:
            raise IOError("corrupt Fortran record")
        off += 8 + ln
        return payload

    body = np.frombuffer(rec(), dtype)
    fa = body.reshape(nv, mz, my, mx).transpose(0, 3, 2, 1)  # F→C order
    tr = np.frombuffer(rec(), dtype)
    n = 1 + mx + my + mz + 3
    deltay = float(tr[n]) if len(tr) > n else None
    t = float(tr[0])
    x = tr[1:1 + mx].astype(np.float64)
    y = tr[1 + mx:1 + mx + my].astype(np.float64)
    z = tr[1 + mx + my:1 + mx + my + mz].astype(np.float64)
    dx, dy, dz = (float(v) for v in tr[1 + mx + my + mz:1 + mx + my + mz + 3])
    return VarFile(np.ascontiguousarray(fa), t, x, y, z, dx, dy, dz, deltay)


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def read_var(path, dim=None, datadir=None) -> VarFile:
    """Read a reference var.dat / VAR<N> file (through the C++ codec where
    it is available)."""
    path = str(path)
    if dim is None:
        ddir = datadir or os.path.dirname(path)
        dim = read_dim(os.path.join(ddir, "dim.dat"))
    mx, my, mz = dim["mx"], dim["my"], dim["mz"]
    nv = dim["mvar"] + dim.get("maux", 0)
    dtype = np.float32 if dim.get("precision", "S").upper().startswith("S") \
        else np.float64
    ws = np.dtype(dtype).itemsize
    lib = native_lib()
    if lib is not None:
        fields = np.empty((nv, mx, my, mz), dtype)
        t = ctypes.c_double()
        x = np.empty(mx, np.float64)
        y = np.empty(my, np.float64)
        z = np.empty(mz, np.float64)
        dxyz = np.empty(3, np.float64)
        deltay = ctypes.c_double(0.0)
        hasd = ctypes.c_int(0)
        rc = lib.pc_read_var(
            path.encode(), mx, my, mz, nv, ws,
            fields.ctypes.data_as(ctypes.c_void_p), ctypes.byref(t),
            _dptr(x), _dptr(y), _dptr(z), _dptr(dxyz),
            ctypes.byref(deltay), ctypes.byref(hasd))
        if rc == 0:
            return VarFile(fields, float(t.value), x, y, z,
                           dxyz[0], dxyz[1], dxyz[2],
                           deltay.value if hasd.value else None)
    return np_read_var(path, mx, my, mz, nv, dtype)


def np_write_var(path, fields, t, x, y, z, dx, dy, dz, deltay=None):
    """The numpy writer: the codec's plain version."""
    dtype = fields.dtype
    body = fields.transpose(0, 3, 2, 1).reshape(-1)  # C→F order
    trailer = np.concatenate([
        np.asarray([t], dtype), np.asarray(x, dtype), np.asarray(y, dtype),
        np.asarray(z, dtype), np.asarray([dx, dy, dz], dtype),
        np.asarray([deltay], dtype) if deltay is not None else
        np.zeros((0,), dtype),
    ])
    _records(path, (body, trailer))


def write_var(path, fields, t, x, y, z, dx, dy, dz, deltay=None):
    """Write a reference-format var.dat from (nv, mx, my, mz) C-order
    (through the C++ codec where it is available)."""
    path = str(path)
    fields = np.ascontiguousarray(fields)
    nv, mx, my, mz = fields.shape
    ws = fields.dtype.itemsize
    lib = native_lib()
    if lib is not None:
        xd = np.ascontiguousarray(x, np.float64)
        yd = np.ascontiguousarray(y, np.float64)
        zd = np.ascontiguousarray(z, np.float64)
        dxyz = np.asarray([dx, dy, dz], np.float64)
        rc = lib.pc_write_var(
            path.encode(), mx, my, mz, nv, ws,
            fields.ctypes.data_as(ctypes.c_void_p), ctypes.c_double(float(t)),
            _dptr(xd), _dptr(yd), _dptr(zd), _dptr(dxyz),
            ctypes.c_double(float(deltay or 0.0)),
            ctypes.c_int(1 if deltay is not None else 0))
        if rc == 0:
            return
    np_write_var(path, fields, t, x, y, z, dx, dy, dz, deltay)


def export_state(model, state, datadir):
    """Dump a port state as a reference-layout data directory (dim.dat +
    var.dat + index.pro stub) readable by `pencil` python/IDL: a global
    data/dim.dat (4-int proc line) plus per-proc data/proc0/{dim,var,
    grid}.dat, and root-level var.dat and grid.dat copies."""
    os.makedirs(datadir, exist_ok=True)
    reg = model.reg
    gs = model.cfg.grid
    fa = model.reg.stack(model.unpack_state(state)["fields"]).cpu().numpy()
    g = gs.nghost
    mx, my, mz = (n + 2 * g for n in gs.shape)
    fg = np.pad(fa, ((0, 0), (g, g), (g, g), (g, g)), mode="wrap")
    write_dim(os.path.join(datadir, "dim.dat"), mx, my, mz,
              reg.nvar, reg.nf - reg.nvar)
    proc0 = os.path.join(datadir, "proc0")
    os.makedirs(proc0, exist_ok=True)
    write_dim(os.path.join(proc0, "dim.dat"), mx, my, mz,
              reg.nvar, reg.nf - reg.nvar, iproc=(0, 0, 0))
    grid = model.grid
    t_now = float(state["t"])
    for ddir in (datadir, proc0):
        write_grid(os.path.join(ddir, "grid.dat"), grid.xgh, grid.ygh,
                   grid.zgh, (gs.dx, gs.dy, gs.dz), (gs.Lx, gs.Ly, gs.Lz),
                   t=t_now)
        write_var(os.path.join(ddir, "var.dat"), fg, t_now,
                  np.asarray(grid.xgh, np.float64),
                  np.asarray(grid.ygh, np.float64),
                  np.asarray(grid.zgh, np.float64), gs.dx, gs.dy, gs.dz)
    with open(os.path.join(datadir, "index.pro"), "w") as f:
        for i, name in enumerate(reg.comp_names):
            f.write(f"i{name}={i + 1}\n")
    write_param_nml(os.path.join(datadir, "param.nml"), model)


def write_param_nml(path, model, io_strategy="dist"):
    """Minimal param.nml for the reference post-processing readers
    (reference param_io.f90 write_all_init_pars; consumed by
    python/pencil/read/params.py — keys used by varfile.py: coord_system,
    lshear, lwrite_aux, io_strategy, gamma, cs0, rho0, cp)."""
    eos = model.eos
    gs = model.cfg.grid
    shear = model.cfg.module("shear")
    with open(path, "w") as f:
        f.write("&init_pars\n")
        f.write(f" coord_system='{gs.coords}',\n")
        f.write(f" lshear={'T' if shear else 'F'},\n")
        f.write(" lwrite_aux=F,\n")
        f.write(" lcollective_io=F,\n")
        f.write(" lwrite_2d=F,\n")
        f.write(f" io_strategy='{io_strategy}',\n")
        f.write(f" xyz0={gs.x0},{gs.y0},{gs.z0}\n")
        f.write(f" lxyz={gs.Lx},{gs.Ly},{gs.Lz}\n")
        lp = ','.join('T' if p else 'F' for p in gs.periodic)
        f.write(f" lperi={lp}\n")
        f.write("/\n")
        f.write(" unit_system='code',\n")
        for u in ("unit_length", "unit_velocity", "unit_density",
                  "unit_temperature", "unit_magnetic", "mu0"):
            f.write(f" {u}=1.0,\n")
        f.write("/\n")
        f.write("&eos_init_pars\n")
        if eos is not None:
            f.write(f" gamma={eos.gamma}, cs0={eos.cs0}, rho0={eos.rho0},"
                    f" cp={eos.cp},\n")
        f.write("/\n")
