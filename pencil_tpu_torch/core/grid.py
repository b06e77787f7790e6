"""Uniform Cartesian grid: interior coordinates and inverse spacings
(counterpart of ``pencil_tpu/core/grid.py`` for ``grid_func='uniform'``).

Every axis of the port is periodic and carries no ghost zones, so the grid
holds interior vectors only.  A periodic axis has its nodes at
x0 + (i + ½)·dx (reference grid.f90:141, the same rule as the JAX grid and
its fused kernel); a degenerate axis (n = 1) has a zero inverse spacing.
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


def _coords(n: int, x0: float, L: float, periodic: bool):
    if n == 1:
        return np.full((1,), x0 + 0.5 * L)
    if periodic:
        xi = (1.0 / n) * (np.arange(n) + 0.5)
    else:
        xi = (1.0 / max(n - 1, 1)) * np.arange(n)
    return x0 + L * xi


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
    vec = [torch.as_tensor(_coords(n, x0, L, p), dtype=dtype, device=device)
           for n, x0, L, p in zip(spec.shape, (spec.x0, spec.y0, spec.z0),
                                  (spec.Lx, spec.Ly, spec.Lz), spec.periodic)]
    inv = [torch.tensor(i, dtype=dtype, device=device)
           for i in inverse_spacings(spec)]
    return Grid(x=vec[0], y=vec[1], z=vec[2],
                dx1=inv[0], dy1=inv[1], dz1=inv[2])
