"""Vertical gravity (counterpart of the ``gravz_profile`` 'const' and
'linear-z' cases of ``pencil_tpu/physics/gravity.py``, ``potential_field``
:145-151, ``gvec`` :156-213 and ``rhs`` :215-221; reference
src/gravity_simple.f90): du/dt += (0, 0, g_z(z)) with g_z = gravz
('const') or gravz·z ('linear-z', alias 'linear': gravz = −Ω² gives the
vertical gravity of a stratified disc)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from .base import ModuleBase, accumulate

PROFILES = ("const", "linear-z", "linear")


@dataclass(frozen=True)
class Gravity(ModuleBase):
    name: ClassVar[str] = "gravity"

    gravz_profile: str = "const"
    gravz: float = 0.0
    gravx: float = 0.0

    def __post_init__(self):
        if self.gravz_profile not in PROFILES or self.gravx != 0.0:
            raise NotImplementedError(
                f"pencil_tpu_torch: gravity {self.gravz_profile!r}, "
                f"gravx={self.gravx} (only gravz 'const' and 'linear-z')")

    @property
    def linear(self) -> bool:
        return self.gravz_profile != "const"

    def gz(self, z):
        """g_z on the z vector ``z``, a vector of its shape (what the
        z-ghosted kernels read)."""
        if self.linear:
            return self.gravz * z
        return torch.full_like(z, self.gravz)

    def potential_field(self, grid, spec):
        """Φ on the interior grid, broadcastable against (nx, ny, nz):
        −gravz·z for 'const' (JAX's with zinfty = 0), −½·gravz·z² for
        'linear-z'."""
        z = grid.zg
        if self.linear:
            return -0.5 * self.gravz * z ** 2
        return -self.gravz * z

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
