"""Momentum equation (counterpart of ``pencil_tpu/physics/hydro.py:133-238``):

    Du/Dt = −∇p/ρ [+ Σ_a |u_a|δ⁶_a u/(60Δ_a)] − 2Ω×u + (viscous, Lorentz,
            shear terms from their own modules)

Hydro owns advection, with 5th-order upwinding of each component where
``lupw_uu`` (JAX hydro.py:161-167, after the pressure force and before
the Coriolis force; no CFL term), the pressure force, the Coriolis force (Ω at angle
θ from the z axis, in degrees) and the advective CFL terms: advec_uu =
Σ_a |u_a|·dline_1_a linearly, and cs²·Σ_a Δ_a⁻² squared.

``lremove_mean_momenta`` (JAX hydro.py:98-116, reference
remove_mean_momenta, hydro.f90:7346; the shearing box's guard against a
mean wind) takes the volume-mean momentum out of u after every step:
u −= ⟨ρu⟩/⟨ρ⟩ with ρ = exp(lnρ).  The model runs it after the
boundary-plane writeback and before the forcing kick, the order of the
JAX after-step hooks (Hydro before Forcing)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import torch

from ..integrate.timestep import dxyz2
from .base import ModuleBase, accumulate
from .initcond import init_vector


@dataclass(frozen=True)
class Hydro(ModuleBase):
    name: ClassVar[str] = "hydro"

    lupw_uu: bool = False     # 5th-order upwinding of (u·∇)u
    Omega: float = 0.0        # rotation rate
    theta: float = 0.0        # angle of Ω from the z axis, degrees
    init: str = "zero"
    ampl: float = 0.0
    lremove_mean_momenta: bool = False

    def register(self, reg):
        reg.register("uu", 3, "pde", comps=("ux", "uy", "uz"))

    def omega_vector(self):
        """Ω as (Ωx, Ωy, Ωz) host floats (JAX hydro.py:169-170)."""
        th = math.radians(self.theta)
        return (self.Omega * math.sin(th), 0.0, self.Omega * math.cos(th))

    def remove_mean_momenta(self, uu, lnrho):
        """u − ⟨ρu⟩/⟨ρ⟩, ρ = exp(lnρ), as a new tensor: device tensor ops
        only, no host sync."""
        rho = torch.exp(lnrho)
        rum = torch.mean(rho[None] * uu, dim=(1, 2, 3))
        return uu - (rum / torch.mean(rho))[:, None, None, None]

    def rhs(self, pen, df, ts):
        out = -pen.ugu() + pen.fpres()
        if self.lupw_uu:
            # +Σ_a |u_a|·δ⁶_a u/(60Δ_a) per component
            out = out + pen.upwind("uu", pen.uu())
        if self.Omega != 0.0:
            om = self.omega_vector()
            uu = pen.uu()
            # −2Ω×u  (coriolis_cartesian, src/hydro.f90)
            out = out + (-2.0) * torch.stack([
                om[1] * uu[2] - om[2] * uu[1],
                om[2] * uu[0] - om[0] * uu[2],
                om[0] * uu[1] - om[1] * uu[0],
            ])
        accumulate(df, "uu", out)
        d1 = pen.dline_1()
        uua = pen.uu_advec()
        ts.advec(sum(uua[a].abs() * d1[a] for a in range(3)))
        ts.advec2(pen.cs2() * dxyz2(pen.grid))

    def init_fields(self, grid, spec, generator, cfg=None):
        return {"uu": init_vector(self.init, grid, spec, generator,
                                  ampl=self.ampl)}
