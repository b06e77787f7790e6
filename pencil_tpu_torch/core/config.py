"""Static configuration objects (counterpart of ``pencil_tpu/core/config.py``).

Field names and defaults are the JAX package's, so one kwargs dict builds
both packages' configurations.  The port accepts a subset of the values
(uniform Cartesian, fully periodic, one device); ``Model`` raises
``NotImplementedError`` on the rest.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Tuple

TWO_PI = 2.0 * math.pi


@dataclass(frozen=True)
class GridSpec:
    """Grid geometry; axis order (x, y, z) with z the fastest array axis."""

    nx: int = 32
    ny: int = 32
    nz: int = 32
    x0: float = -math.pi
    y0: float = -math.pi
    z0: float = -math.pi
    Lx: float = TWO_PI
    Ly: float = TWO_PI
    Lz: float = TWO_PI
    periodic: Tuple[bool, bool, bool] = (True, True, True)
    nghost: int = 3
    coords: str = "cartesian"
    grid_func: Tuple[str, str, str] = ("uniform", "uniform", "uniform")
    grid_coeff: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    xyz_star: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    grid_step: Tuple[tuple, tuple, tuple] = ((), (), ())
    lshift_origin: Tuple[bool, bool, bool] = (False, False, False)
    lpole: Tuple[bool, bool, bool] = (False, False, False)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    @property
    def dx(self) -> float:
        """Uniform spacing; periodic axes exclude the duplicate endpoint."""
        return self.Lx / self.nx if self.periodic[0] else self.Lx / max(self.nx - 1, 1)

    @property
    def dy(self) -> float:
        if self.periodic[1] or self.lpole[1]:
            return self.Ly / self.ny
        return self.Ly / max(self.ny - 1, 1)

    @property
    def dz(self) -> float:
        return self.Lz / self.nz if self.periodic[2] else self.Lz / max(self.nz - 1, 1)


@dataclass(frozen=True)
class MeshSpec:
    """Device-mesh layout.  The port runs on one device: only (1, 1, 1)."""

    px: int = 1
    py: int = 1
    pz: int = 1

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.px, self.py, self.pz)


@dataclass(frozen=True)
class TimeSpec:
    """Time-integration parameters (2N-RK order and CFL coefficients)."""

    itorder: int = 3
    cdt: float = 0.9
    cdtv: float = 0.25
    cdtv3: float = 0.01
    cdts: float = 1.0
    dt: float = 0.0            # fixed dt if > 0, else adaptive
    dtmin: float = 1.0e-10
    dtmax: float = 1.0e37
    ddt: float = 0.0           # max dt growth ratio per step (0 = off)
    eps_rkf: float = 1.0e-8
    tstart: float = 0.0


@dataclass(frozen=True)
class Config:
    """Top-level static configuration: grid, time, and the tuple of physics
    module configs.  ``fused`` selects the hand-written kernel chain."""

    grid: GridSpec = field(default_factory=GridSpec)
    mesh: MeshSpec = field(default_factory=MeshSpec)
    time: TimeSpec = field(default_factory=TimeSpec)
    modules: tuple = ()
    dtype: str = "float32"
    fused: bool = False
    bcx: tuple = ()
    bcy: tuple = ()
    bcz: tuple = ()
    force_bound: tuple = ("", "")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def module(self, name: str):
        for m in self.modules:
            if m.name == name:
                return m
        return None
