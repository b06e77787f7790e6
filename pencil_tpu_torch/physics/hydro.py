"""Momentum equation (counterpart of ``pencil_tpu/physics/hydro.py:133-238``):

    Du/Dt = −∇p/ρ + (viscous, Lorentz terms from their own modules)

Hydro owns advection, the pressure force and the advective CFL terms:
advec_uu = Σ_a |u_a|·dline_1_a linearly, and cs²·Σ_a Δ_a⁻² squared."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

from ..integrate.timestep import dxyz2
from .base import ModuleBase, accumulate
from .initcond import init_vector


@dataclass(frozen=True)
class Hydro(ModuleBase):
    name: ClassVar[str] = "hydro"

    init: str = "zero"
    ampl: float = 0.0

    def register(self, reg):
        reg.register("uu", 3, "pde", comps=("ux", "uy", "uz"))

    def rhs(self, pen, df, ts):
        accumulate(df, "uu", -pen.ugu() + pen.fpres())
        d1 = pen.dline_1()
        uua = pen.uu_advec()
        ts.advec(sum(uua[a].abs() * d1[a] for a in range(3)))
        ts.advec2(pen.cs2() * dxyz2(pen.grid))

    def init_fields(self, grid, spec, generator, cfg=None):
        return {"uu": init_vector(self.init, grid, spec, generator,
                                  ampl=self.ampl)}
