"""Uniform Cartesian grid: coordinates and inverse spacings (counterpart of
``pencil_tpu/core/grid.py`` for ``grid_func='uniform'``).

The grid holds the interior coordinate vectors on the device, which the
stencils and modules read, and the ghosted vectors of the JAX grid
(``_axis_coords``, pencil_tpu/core/grid.py:102-130) as float32 numpy
arrays on the host, which the boundary conditions read as host scalars
without a device sync.  A
periodic axis has its nodes at x0 + (i + ½)·dx (reference grid.f90:141,
the same rule as the JAX grid and its fused kernel); a non-periodic axis
at x0 + i·L/(n−1); a degenerate axis (n = 1) has a zero inverse spacing.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .config import GridSpec


@dataclass(frozen=True)
class Grid:
    x: torch.Tensor          # (nx,) interior coordinates
    y: torch.Tensor          # (ny,)
    z: torch.Tensor          # (nz,)
    dx1: torch.Tensor        # 0-d inverse spacings
    dy1: torch.Tensor
    dz1: torch.Tensor
    xgh: np.ndarray          # (nx + 2g,) ghosted coordinates, host f32
    ygh: np.ndarray
    zgh: np.ndarray
    dx_1: np.ndarray         # (nx + 2g,) ghosted inverse spacings, host f32
    dy_1: np.ndarray
    dz_1: np.ndarray

    @property
    def xg(self):
        return self.x[:, None, None]

    @property
    def yg(self):
        return self.y[None, :, None]

    @property
    def zg(self):
        return self.z[None, None, :]

    def dline_1(self):
        """Per-axis inverse line elements (advective CFL, derivatives)."""
        return (self.dx1, self.dy1, self.dz1)


def _axis_coords(n: int, x0: float, L: float, periodic: bool, g: int):
    """Ghosted coordinates and inverse spacings of one axis, float64."""
    m = n + 2 * g
    if n == 1:
        return np.full((m,), x0 + 0.5 * L), np.zeros((m,))
    if periodic:
        dxi = 1.0 / n
        xi = dxi * (np.arange(-g, n + g) + 0.5)
    else:
        dxi = 1.0 / max(n - 1, 1)
        xi = dxi * np.arange(-g, n + g)
    return x0 + L * xi, np.full((m,), 1.0 / (L * dxi))


def inverse_spacings(spec: GridSpec):
    """(1/dx, 1/dy, 1/dz) as host floats; 0 on a degenerate axis."""
    return tuple(0.0 if n == 1 else 1.0 / d
                 for n, d in zip(spec.shape, (spec.dx, spec.dy, spec.dz)))


def make_grid(spec: GridSpec, device, dtype=torch.float32) -> Grid:
    if spec.coords != "cartesian" or any(f != "uniform" for f in spec.grid_func):
        raise NotImplementedError(
            "pencil_tpu_torch: uniform Cartesian grids only")
    if any(spec.lshift_origin) or any(spec.lpole):
        raise NotImplementedError("pencil_tpu_torch: lshift_origin/lpole")
    g = spec.nghost
    npdtype = torch.empty((), dtype=dtype).numpy().dtype
    (xg, dxg), (yg, dyg), (zg, dzg) = [
        [v.astype(npdtype) for v in _axis_coords(n, x0, L, p, g)]
        for n, x0, L, p in zip(spec.shape, (spec.x0, spec.y0, spec.z0),
                               (spec.Lx, spec.Ly, spec.Lz), spec.periodic)]
    vec = [torch.as_tensor(v[g:-g], device=device) for v in (xg, yg, zg)]
    inv = [torch.tensor(i, dtype=dtype, device=device)
           for i in inverse_spacings(spec)]
    return Grid(x=vec[0], y=vec[1], z=vec[2],
                dx1=inv[0], dy1=inv[1], dz1=inv[2],
                xgh=xg, ygh=yg, zgh=zg, dx_1=dxg, dy_1=dyg, dz_1=dzg)
