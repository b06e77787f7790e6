"""Constant vertical gravity (counterpart of the ``gravz_profile='const'``
case of ``pencil_tpu/physics/gravity.py``, ``gvec`` :156-213 and ``rhs``
:215-221; reference src/gravity_simple.f90): du/dt += (0, 0, gravz)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from .base import ModuleBase, accumulate


@dataclass(frozen=True)
class Gravity(ModuleBase):
    name: ClassVar[str] = "gravity"

    gravz_profile: str = "const"
    gravz: float = 0.0
    gravx: float = 0.0

    def __post_init__(self):
        if self.gravz_profile != "const" or self.gravx != 0.0:
            raise NotImplementedError(
                f"pencil_tpu_torch: gravity {self.gravz_profile!r}, "
                f"gravx={self.gravx} (only 'const' gravz)")

    def gvec(self, pen):
        """The acceleration (3, nx, ny, nz), as a broadcast view."""
        lnrho = pen.lnrho()
        g = torch.zeros((3, 1, 1, 1), dtype=lnrho.dtype, device=lnrho.device)
        g[2] = self.gravz
        return g.expand((3,) + tuple(lnrho.shape))

    def rhs(self, pen, df, ts):
        accumulate(df, "uu", self.gvec(pen))
