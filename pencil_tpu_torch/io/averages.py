"""1-D / 2-D and phi averages (counterpart of ``pencil_tpu/io/averages.py``;
reference ``src/diagnostics.f90:838-1012``: xyaverages_z, xzaverages_y,
yzaverages_x, zaverages_xy…; control files ``xyaver.in``/``zaver.in`` list
quantity names like ``uxmz``, ``rhomxy``).

Naming contract kept from the reference: ``<quant>m<dims>`` where the
trailing dims are what the profile *depends on* (so ``uxmz`` = <ux>_{xy}(z),
``bymxy`` = <by>_z(x, y)).  Output: ``data/xyaverages.dat`` style — a time
line followed by the profile values — and ``data/averages/PHIAVG<n>``.

The evaluators run on the model's device: they read the packed or unpacked
state, fill the ghosts of its communicated fields (wraps and BCs, without
the shear shift, as the JAX evaluators' ``fill_ghosts`` call does) and
return each profile as a tensor there; the caller copies them to the host
in one go.  The writers and the reader are host code.
"""
from __future__ import annotations

import os
import struct
from typing import Callable, Dict

import numpy as np
import torch

from ..physics.pencils import Pencils

# base quantity evaluators over a Pencils container
QUANTS: Dict[str, Callable] = {
    "ux": lambda p: p.uu()[0], "uy": lambda p: p.uu()[1], "uz": lambda p: p.uu()[2],
    "ux2": lambda p: p.uu()[0] ** 2, "uy2": lambda p: p.uu()[1] ** 2,
    "uz2": lambda p: p.uu()[2] ** 2, "u2": lambda p: p.u2(),
    "uxuy": lambda p: p.uu()[0] * p.uu()[1],
    "uxuz": lambda p: p.uu()[0] * p.uu()[2],
    "uyuz": lambda p: p.uu()[1] * p.uu()[2],
    "rho": lambda p: p.rho(), "lnrho": lambda p: p.lnrho(),
    "ss": lambda p: p.ss(), "TT": lambda p: p.TT(), "cs2": lambda p: p.cs2(),
    "bx": lambda p: p.bb()[0], "by": lambda p: p.bb()[1], "bz": lambda p: p.bb()[2],
    "bx2": lambda p: p.bb()[0] ** 2, "by2": lambda p: p.bb()[1] ** 2,
    "bz2": lambda p: p.bb()[2] ** 2, "b2": lambda p: p.b2(),
    "bxby": lambda p: p.bb()[0] * p.bb()[1],
    "jb": lambda p: sum(p.jj()[a] * p.bb()[a] for a in range(3)),
    "ab": lambda p: sum(p.aa()[a] * p.bb()[a] for a in range(3)),
    "ekin": lambda p: 0.5 * p.rho() * p.u2(),
    "oum": lambda p: sum(p.oo()[a] * p.uu()[a] for a in range(3)),
}

# profile suffix → axes averaged over (axis indices of (x,y,z))
_SUFFIX_AXES = {
    "mz": (0, 1),    # xy-average, profile in z
    "my": (0, 2),    # xz-average, profile in y
    "mx": (1, 2),    # yz-average, profile in x
    "mxy": (2,),     # z-average, 2-D in (x,y)
    "mxz": (1,),     # y-average, 2-D in (x,z)
    "myz": (0,),     # x-average, 2-D in (y,z)
}
_SUFFIXES = ("mxy", "mxz", "myz", "mz", "my", "mx")


def parse_aver_name(name: str):
    for suf in _SUFFIXES:
        if name.endswith(suf) and name[: -len(suf)] in QUANTS:
            return name[: -len(suf)], _SUFFIX_AXES[suf]
    raise KeyError(f"unknown average name {name!r}")


def ghosted_pencils(model, state):
    """The Pencils of ``state`` (packed or unpacked) on its ghost-filled
    communicated fields, without the shear shift."""
    state = model.unpack_state(state)
    fg = model.ghosted(model.reg.stack(state["fields"]))
    return Pencils(fg, model.grid, model.reg, model.cfg, model.eos,
                   ghosted=True)


def make_averages(model, names):
    """Evaluator: state → {name: profile tensor on the model's device}."""
    parsed = {n: parse_aver_name(n) for n in names}

    def evaluate(state):
        pen = ghosted_pencils(model, state)
        return {n: torch.mean(QUANTS[q](pen), dim=axes)
                for n, (q, axes) in parsed.items()}

    return evaluate


# plane suffix → reference average-file name (diagnostics.f90
# write_1daverages / nohdf5_io.f90 output_average_1D: '<label>averages.dat')
PLANE_FILES = {
    "mz": "xyaverages.dat", "my": "xzaverages.dat", "mx": "yzaverages.dat",
    "mxy": "zaverages.dat", "mxz": "yaverages.dat",
}


def _suffix_of(name):
    for suf in _SUFFIXES:
        if name.endswith(suf):
            return suf
    raise KeyError(name)


class AveragesWriter:
    """Reference-format average writers: per plane, a `1pe12.5` time line
    followed by ALL requested variables' values flattened contiguously and
    wrapped 8 per line (nohdf5_io.f90:923-927 `(1p,8e14.5e3)`) — the layout
    the reference python package `pc.read.aver()` expects.  The
    x-averages (suffix ``myz``) have no file in ``PLANE_FILES``: a name
    with it raises KeyError here, where the JAX writer raises it at its
    first ``append``."""

    def __init__(self, datadir, names):
        self.datadir = str(datadir)
        # group names by plane, preserving order (the .in file order)
        self.groups: Dict[str, list] = {}
        for n in names:
            self.groups.setdefault(_suffix_of(n), []).append(n)
        nofile = [n for suf, ns in self.groups.items()
                  if suf not in PLANE_FILES for n in ns]
        if nofile:
            raise KeyError(f"no average file for the x-averages {nofile}")

    def append(self, t, values: Dict[str, np.ndarray]):
        for suf, names in self.groups.items():
            path = os.path.join(self.datadir, PLANE_FILES[suf])
            flat = np.concatenate(
                [np.asarray(values[n], np.float64).ravel() for n in names])
            with open(path, "a") as f:
                f.write(f"{float(t):12.5E}\n")
                for i in range(0, len(flat), 8):
                    f.write("".join(f"{x:14.5E}" for x in flat[i:i + 8])
                            + "\n")


def make_phi_averages(model, names):
    """Azimuthal (phi) averages around the z axis onto (r_cyl, z)
    (reference diagnostics.f90 calc_phiavg_profile :2775 +
    phisum_mn_name_rz :2805): quartic-Gaussian radial binning
    w = exp(-((r-r0)/(0.7 drcyl))^4 / 2) with nrcyl = nxgrid/2 bins,
    rcyl_i = (i-0.5)·drcyl, drcyl = xyz1(1)/nrcyl; the average is
    sum(w·q)/sum(w) over each z plane.  The weights are built in float64
    on the host from the float32 coordinates and kept on the device in
    float32, as is their sum.  Returns (evaluate, rcyl, drcyl); evaluate
    gives (nc, nrcyl, nz) on the model's device."""
    spec = model.cfg.grid
    g = spec.nghost
    nrcyl = max(spec.nx // 2, 1)
    x1 = spec.x0 + spec.Lx
    drcyl = x1 / nrcyl
    rcyl = (np.arange(1, nrcyl + 1) - 0.5) * drcyl
    x = model.grid.xgh[g:-g][:, None]
    y = model.grid.ygh[g:-g][None, :]
    rmn = np.sqrt(x * x + y * y)                       # (nx, ny)
    width = 0.7 * drcyl
    w = np.exp(-0.5 * ((rmn[None] - rcyl[:, None, None]) / width) ** 4)
    dev = dict(dtype=model.dtype, device=model.device)
    wsum = torch.tensor(w.sum(axis=(1, 2)), **dev)     # (nrcyl,)
    wj = torch.tensor(w, **dev).reshape(nrcyl, -1)
    quants = [QUANTS[n[:-4] if n.endswith("mphi") else n] for n in names]

    def evaluate(state):
        pen = ghosted_pencils(model, state)
        # (nrcyl, nx·ny) @ (nx·ny, nz): einsum("rxy,xyz->rz")
        return torch.stack([
            (wj @ q(pen).reshape(wj.shape[1], -1)) / wsum[:, None]
            for q in quants])

    return evaluate, rcyl, drcyl


def _frec(f, payload: bytes):
    f.write(struct.pack("<i", len(payload)))
    f.write(payload)
    f.write(struct.pack("<i", len(payload)))


class PhiAvgWriter:
    """data/averages/PHIAVG<n> in the reference's unformatted-record layout
    (nohdf5_io.f90 output_average_phi): (nr, nzgrid, nc, nprocz) · (t, r,
    z, dr, dz) · data(nr, nz, nc) · labels — readable by the reference
    python package `pc.read.phiaver()`, plus phiavg.list / phiavg.files.
    ``grid`` is the model's grid (its ghosted z coordinates on the
    host)."""

    def __init__(self, datadir, names, grid, spec, rcyl, drcyl):
        self.dir = os.path.join(str(datadir), "averages")
        os.makedirs(self.dir, exist_ok=True)
        self.names = list(names)
        self.n = 0
        self.rcyl = np.asarray(rcyl, np.float32)
        self.drcyl = float(drcyl)
        zz = np.asarray(grid.zgh)
        if zz.shape[0] > spec.nz:
            zz = zz[3:-3]
        self.z = zz.astype(np.float32)
        self.dz = float(spec.Lz / max(spec.nz, 1))
        with open(os.path.join(self.dir, "phiavg.list"), "w") as f:
            for n in self.names:
                f.write(n + "\n")

    def append(self, t, data):
        """data: (nc, nrcyl, nz)."""
        self.n += 1
        fname = f"PHIAVG{self.n}"
        data = np.asarray(data, np.float32)
        nc, nr, nz = data.shape
        with open(os.path.join(self.dir, fname), "wb") as f:
            _frec(f, struct.pack("<4i", nr, nz, nc, 1))
            rec2 = np.concatenate([[np.float32(t)], self.rcyl, self.z,
                                   [np.float32(self.drcyl)],
                                   [np.float32(self.dz)]]).astype(np.float32)
            _frec(f, rec2.tobytes())
            # Fortran-order (nr, nz, nc) flattening
            _frec(f, np.transpose(data, (0, 2, 1)).astype(np.float32)
                  .tobytes())
            labels = ",".join(self.names)
            _frec(f, struct.pack("<i", len(labels)) + labels.encode())
        with open(os.path.join(self.dir, "phiavg.files"), "a") as f:
            f.write(fname + "\n")


def read_averages(path, names, shape_of: Dict[str, int]):
    """Read back; shape_of maps name → profile length."""
    times = []
    data = {n: [] for n in names}
    with open(path) as f:
        tokens = f.read().split("\n")
    i = 0
    while i < len(tokens):
        line = tokens[i].strip()
        if not line:
            i += 1
            continue
        times.append(float(line.split()[0]))
        i += 1
        vals = []
        need = sum(shape_of[n] for n in names)
        while len(vals) < need and i < len(tokens):
            vals.extend(float(v) for v in tokens[i].split())
            i += 1
        off = 0
        for n in names:
            ln = shape_of[n]
            data[n].append(np.asarray(vals[off:off + ln]))
            off += ln
    return np.asarray(times), {n: np.asarray(v) for n, v in data.items()}
