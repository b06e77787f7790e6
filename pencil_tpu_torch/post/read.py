"""Post-processing read API (counterpart of ``pencil_tpu/post/read.py``;
reference ``python/pencil``: ``pc.read.ts() / var() / slices() / aver() /
power()`` over a data directory).

Host numpy code over the run's native outputs: ``time_series.dat``, the
``.npz`` snapshots, the slice ``.npz`` files, the ``*averages.dat`` files
and ``power_*.dat``; and the reference-format var.dat through the codec
of ``compat/io_dist.py``.  HDF5 snapshots are not ported.
"""
from __future__ import annotations

import glob
import os
from types import SimpleNamespace

import numpy as np

from ..io.averages import PLANE_FILES, _suffix_of, read_averages
from ..io.slices import read_slices
from ..io.snapshot import load_snapshot
from ..io.spectra import read_spectrum
from ..io.timeseries import read_time_series


def ts(datadir="data"):
    """Time series as an object with one array attribute per column
    (pc.read.ts contract: ts.t, ts.urms, ...)."""
    data = read_time_series(os.path.join(str(datadir), "time_series.dat"))
    return SimpleNamespace(**{k: np.asarray(v) for k, v in data.items()},
                           keys=list(data))


def var(varfile="var.npz", datadir="data", trimall=False):
    """Snapshot as an object with named field arrays (pc.read.var contract:
    var.uu, var.lnrho, ..., var.t, var.dt, var.it) from an ``.npz``
    snapshot, the port's or the JAX package's; or from a reference-format
    var.dat (``f``, ``t``, the coordinates and spacings, ``deltay``, and a
    component per ``index.pro`` entry beside the file, its ghost zones cut
    with ``trimall``), as JAX ``post/read.py:30-85`` reads it."""
    path = os.path.join(str(datadir), str(varfile))
    if not os.path.exists(path) and os.path.exists(str(varfile)):
        path = str(varfile)
    if path.endswith(".npz"):
        st = load_snapshot(path, device="cpu")
        return SimpleNamespace(
            **{k: v.numpy() for k, v in st["fields"].items()},
            t=float(st["t"]), dt=float(st["dt"]), it=int(st["it"]))
    if path.endswith(".h5"):
        raise NotImplementedError(
            f"pencil_tpu_torch.post.read.var: {path}: the HDF5 codec is "
            "not ported")
    from ..compat.io_dist import read_var
    vf = read_var(path, datadir=datadir)
    ns = SimpleNamespace(f=vf.f, t=vf.t, x=vf.x, y=vf.y, z=vf.z,
                         dx=vf.dx, dy=vf.dy, dz=vf.dz, deltay=vf.deltay)
    idx_path = os.path.join(os.path.dirname(path), "index.pro")
    if os.path.exists(idx_path):
        sl = (slice(3, -3) if trimall else slice(None),) * 3
        with open(idx_path) as fh:
            for line in fh:
                if "=" in line:
                    name, num = line.strip().split("=")
                    i = int(num) - 1
                    if 0 <= i < vf.f.shape[0]:
                        setattr(ns, name.lstrip("i"), vf.f[(i,) + sl])
    return ns


def slices(field="ux", plane="xy", datadir="data"):
    t, data = read_slices(os.path.join(str(datadir),
                                       f"slice_{field}_{plane}.npz"))
    return SimpleNamespace(t=t, data=data)


def aver(datadir="data", names=None, shape_of=None, file=None):
    """The profiles ``names`` of one average file (each of ``shape_of[name]``
    values) and their times.  ``file`` defaults to the plane file of the
    names' suffix (``xyaverages.dat`` for ``uxmz``, …), and to
    ``averages.dat`` when the names span no single plane."""
    names = list(names or [])
    if file is None:
        planes = {_suffix_of(n) for n in names}
        file = (PLANE_FILES.get(planes.pop(), "averages.dat")
                if len(planes) == 1 else "averages.dat")
    t, data = read_averages(os.path.join(str(datadir), file), names,
                            shape_of or {})
    return SimpleNamespace(t=t, **data)


def power(name="kin", datadir="data"):
    t, spec = read_spectrum(os.path.join(str(datadir), f"power_{name}.dat"))
    return SimpleNamespace(t=t, spec=spec)


def snapshots(datadir="data"):
    """List enumerated VAR<N> snapshots (newest last)."""
    files = sorted(glob.glob(os.path.join(str(datadir), "VAR*.npz")),
                   key=lambda p: int("".join(c for c in os.path.basename(p)
                                             if c.isdigit()) or 0))
    return files
