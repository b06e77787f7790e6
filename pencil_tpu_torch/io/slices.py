"""Video slices (counterpart of ``pencil_tpu/io/slices.py``; reference
``src/slices.f90``: ``wvid_prepare``/``wvid``, ``video.in`` lists fields,
planes xy/xy2/xz/yz written at dvid cadence to
``data/proc*/slice_<field>.<plane>``).

Per-plane time series kept in memory and flushed by the run loop into
``data/slice_<field>_<plane>.npz``, holding arrays ``t`` (nt,) and ``data``
(nt, n1, n2).  A capture evaluates each field on the model's device, cuts
its planes there and copies the planes and t to the host in one go.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from .averages import QUANTS, ghosted_pencils

PLANES = {
    "xy": lambda a, iz: a[:, :, iz],
    "xy2": lambda a, iz: a[:, :, -max(iz, 1)],
    "xz": lambda a, iy: a[:, iy, :],
    "yz": lambda a, ix: a[ix, :, :],
}


class SliceWriter:
    def __init__(self, datadir, fields=("ux", "uz"), planes=("xy", "xz"),
                 index=None):
        self.datadir = str(datadir)
        self.fields = list(fields)
        self.planes = list(planes)
        self.index = index  # plane positions; default mid-box
        self._buf: Dict[str, List] = {}
        self._t: List[float] = []

    def capture(self, model, state):
        pen = ghosted_pencils(model, state)
        n = model.cfg.grid.shape
        mid = {"xy": n[2] // 2, "xy2": 1, "xz": n[1] // 2, "yz": n[0] // 2}
        keys, cuts = [], []
        for f in self.fields:
            arr = QUANTS[f](pen)
            for p in self.planes:
                keys.append(f"{f}_{p}")
                cuts.append(PLANES[p](arr, self.index or mid[p]))
        t = model.unpack_state(state)["t"].reshape(1).to(model.dtype)
        host = torch.cat([t] + [c.reshape(-1) for c in cuts]).cpu().numpy()
        self._t.append(float(host[0]))
        off = 1
        for key, c in zip(keys, cuts):
            self._buf.setdefault(key, []).append(
                host[off:off + c.numel()].reshape(c.shape))
            off += c.numel()

    def flush(self):
        os.makedirs(self.datadir, exist_ok=True)
        for key, frames in self._buf.items():
            path = os.path.join(self.datadir, f"slice_{key}.npz")
            if os.path.exists(path):
                with np.load(path) as z:
                    t0, d0 = list(z["t"]), list(z["data"])
            else:
                t0, d0 = [], []
            np.savez(path, t=np.asarray(t0 + self._t),
                     data=np.asarray(d0 + frames))
        self._buf = {}
        self._t = []


def read_slices(path):
    with np.load(path) as z:
        return z["t"], z["data"]
