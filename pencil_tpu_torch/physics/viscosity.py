"""Viscous force, 'nu-const' on Cartesian grids (counterpart of
``pencil_tpu/physics/viscosity.py:43-63``):

    f = ν(∇²u + ⅓∇∇·u + 2S·∇lnρ)

With an entropy slot it publishes the viscous heating 2νS² into the pencil
cache for the entropy module (JAX viscosity.py:224-227).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Tuple

import torch

from .base import ModuleBase, accumulate


@dataclass(frozen=True)
class Viscosity(ModuleBase):
    name: ClassVar[str] = "viscosity"

    ivisc: Tuple[str, ...] = ("nu-const",)
    nu: float = 0.0

    def __post_init__(self):
        if tuple(self.ivisc) != ("nu-const",):
            raise NotImplementedError(
                f"pencil_tpu_torch: ivisc={self.ivisc!r} (only nu-const)")

    def rhs(self, pen, df, ts):
        if self.nu <= 0.0:
            return
        sij = pen.sij()
        glnrho = pen.glnrho()
        sglnrho = torch.stack([
            sum(sij[a, b] * glnrho[b] for b in range(3)) for a in range(3)
        ])
        accumulate(df, "uu", self.nu * (
            pen.del2u() + (1.0 / 3.0) * pen.graddivu() + 2.0 * sglnrho))
        if "ss" in pen.reg.slots:
            pen._cache["visc_heat"] = 2.0 * self.nu * pen.sij2()
        ts.diffus(self.nu)
