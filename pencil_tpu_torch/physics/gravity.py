"""Vertical gravity (counterpart of the z profiles of
``pencil_tpu/physics/gravity.py``: fields :48-79, ``potential_field``
:121-151, the z branches of ``gvec`` :195-213 and ``rhs`` :215-221;
reference src/gravity_simple.f90): du/dt += (0, 0, g_z(z)) with

    'const'              g_z = gravz,          Φ = −gravz·(z − zinfty)
    'zero'               g_z = 0,              Φ = 0
    'linear-z' ('linear') g_z = gravz·z,       Φ = −½·gravz·z²
                         (gravz = −Ω² gives the vertical gravity of a
                         stratified disc)
    'sin-z'              g_z = gravz·sin(κz),  Φ = (gravz/κ)·cos(κz)
                         (κ = ``kappa_z``: a periodic hydrostatic state)
    'Ferriere'           the Galactic disc's g_z of Ferrière (1998), eq.
                         34, in the run's units, Φ = 0 as in JAX.

Each profile is a function of z alone: ``gz(z)`` gives it as a vector,
which ``gvec`` and the fused kernels both read.  An x profile (``gravx``,
``gravx_profile``), the central and the radial (``ipotential``)
potentials raise."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from .base import ModuleBase, accumulate

PROFILES = ("const", "zero", "linear-z", "linear", "sin-z", "Ferriere")


@dataclass(frozen=True)
class Gravity(ModuleBase):
    name: ClassVar[str] = "gravity"

    gravz_profile: str = "const"
    gravz: float = 0.0
    gravx: float = 0.0
    gravx_profile: str = "const"
    # top of the polytropic atmosphere: Φ = −g_z(z − z∞) ('const')
    zinfty: float = 0.0
    # cgs base units for 'Ferriere'
    unit_length: float = 1.0
    unit_velocity: float = 1.0
    kappa_z: float = 1.0     # for 'sin-z': g = gravz·sin(kappa_z·z)
    ipotential: str = ""

    def __post_init__(self):
        if (self.gravz_profile not in PROFILES
                and self.gravz_profile.lower() != "ferriere") \
                or self.gravx != 0.0 or self.gravx_profile != "const" \
                or self.ipotential:
            raise NotImplementedError(
                f"pencil_tpu_torch: gravity {self.gravz_profile!r}, "
                f"gravx={self.gravx}, gravx_profile={self.gravx_profile!r}, "
                f"ipotential={self.ipotential!r} (only the z profiles "
                f"{PROFILES})")

    def gz(self, z):
        """g_z on the z vector ``z``, a vector of its shape (what the fused
        kernels read), in JAX's f32 arithmetic: each Python constant is
        rounded to f32 where it meets the vector."""
        prof = self.gravz_profile
        if prof == "const":
            return torch.full_like(z, self.gravz)
        if prof == "zero":
            return torch.zeros_like(z)
        if prof in ("linear-z", "linear"):
            return self.gravz * z
        if prof == "sin-z":
            return self.gravz * torch.sin(self.kappa_z * z)
        # Ferrière ApJ 497, 759 (1998) eq. 34 at the solar radius
        # (gravity_simple.f90:536-553): the stellar disc's and the dark
        # halo's terms, cgs constants a_S = 4.4e-9, z_S = 6.172e20, a_D =
        # 1.7e-9, z_D = 3.086e21 in the run's units.  g_B² is formed in
        # double and rounded to f32 where it meets z²: at the default units
        # that is inf, and the first term 0, as in JAX
        uv, ul = self.unit_velocity, self.unit_length
        utime = ul / uv
        g_A = 4.4e-9 / uv * utime
        g_B = 6.172e20 / ul
        g_C = 1.7e-9 / uv * utime
        g_D = 3.086e21 / ul

        def f32(v):
            return torch.tensor(v, dtype=z.dtype, device=z.device)

        return -(f32(g_A) * z / torch.sqrt(z ** 2 + f32(g_B ** 2))
                 + f32(g_C) * z / f32(g_D))

    def potential_field(self, grid, spec):
        """Φ on the interior grid, broadcastable against (nx, ny, nz);
        JAX's for every z profile ('Ferriere' has none: 0)."""
        z = grid.zg
        prof = self.gravz_profile
        if prof == "const":
            return -self.gravz * (z - self.zinfty)
        if prof in ("linear-z", "linear"):
            return -0.5 * self.gravz * z ** 2
        if prof == "sin-z":
            return (self.gravz / self.kappa_z) * torch.cos(self.kappa_z * z)
        return torch.zeros_like(z)

    def gvec(self, pen):
        """The acceleration (3, nx, ny, nz), as a broadcast view."""
        lnrho = pen.lnrho()
        z = pen.grid.z
        g = torch.zeros((3, 1, 1) + tuple(z.shape), dtype=lnrho.dtype,
                        device=lnrho.device)
        g[2, 0, 0] = self.gz(z)
        return g.expand((3,) + tuple(lnrho.shape))

    def rhs(self, pen, df, ts):
        accumulate(df, "uu", self.gvec(pen))
