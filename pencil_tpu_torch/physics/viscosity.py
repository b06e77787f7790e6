"""Viscous force on Cartesian grids (counterpart of
``pencil_tpu/physics/viscosity.py:38-227``), the sum of the selected
flavours in the JAX order:

    'nu-const'           ν(∇²u + ⅓∇∇·u + 2S·∇lnρ)
    'nu-shock'           ν_sh[shock(∇∇·u + ∇·u ∇lnρ) + ∇·u ∇shock]
    'hyper3-simplified'  ν₃ Σ_a ∂⁶u/∂x_a⁶
    'hyper3-mesh'        ν₃ᵐ·π⁻⁵ Σ_a δ⁶_a u·dline_1_a/60, whose rate
                         ν₃ᵐ·π⁻⁵·√Σ_a dline_1_a² joins the advective CFL
                         (``advec_mesh``)

'nu-const' is always selected; the other three are optional.  With an
entropy slot the viscous heating (2νS² + ν_sh·shock·(∇·u)²) goes into the
pencil cache for the entropy module (JAX viscosity.py:224-227).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Tuple

import torch

from .base import ModuleBase, accumulate

OPTIONAL = ("nu-shock", "hyper3-simplified", "hyper3-mesh")

# π⁻⁵ of the mesh flavours' normalisation (JAX viscosity.py:219, reference
# viscosity.f90:1857)
PI5_1 = 1.0 / 306.0196847852814


@dataclass(frozen=True)
class Viscosity(ModuleBase):
    name: ClassVar[str] = "viscosity"

    ivisc: Tuple[str, ...] = ("nu-const",)
    nu: float = 0.0
    nu_hyper3: float = 0.0
    nu_shock: float = 0.0
    nu_hyper3_mesh: float = 5.0

    def __post_init__(self):
        iv = tuple(self.ivisc)
        if "nu-const" not in iv or len(set(iv)) != len(iv) \
                or not set(iv) <= {"nu-const", *OPTIONAL}:
            raise NotImplementedError(
                f"pencil_tpu_torch: ivisc={self.ivisc!r} (nu-const, with "
                f"optional {' and '.join(OPTIONAL)})")

    def coefficients(self):
        """(ν, ν_sh, ν₃) with 0 for a flavour that contributes nothing."""
        iv = set(self.ivisc)
        return (max(self.nu, 0.0),
                max(self.nu_shock, 0.0) if "nu-shock" in iv else 0.0,
                max(self.nu_hyper3, 0.0) if "hyper3-simplified" in iv
                else 0.0)

    def mesh_coefficient(self):
        """ν₃ᵐ of 'hyper3-mesh', 0 where it contributes nothing."""
        return (max(self.nu_hyper3_mesh, 0.0) if "hyper3-mesh" in self.ivisc
                else 0.0)

    def rhs(self, pen, df, ts):
        nu, nu_shock, nu_hyper3 = self.coefficients()
        heating = "ss" in pen.reg.slots
        fvisc = 0.0
        heat = 0.0
        if nu > 0.0:
            sij = pen.sij()
            glnrho = pen.glnrho()
            sglnrho = torch.stack([
                sum(sij[a, b] * glnrho[b] for b in range(3))
                for a in range(3)])
            fvisc = fvisc + nu * (pen.del2u() + (1.0 / 3.0) * pen.graddivu()
                                  + 2.0 * sglnrho)
            if heating:
                heat = heat + 2.0 * nu * pen.sij2()
            ts.diffus(nu)
        if nu_shock > 0.0:
            shock = pen.field("shock")
            gshock = pen.grad("shock")
            divu = pen.divu()
            fvisc = fvisc + nu_shock * (
                shock[None] * (pen.graddivu() + divu[None] * pen.glnrho())
                + divu[None] * gshock)
            if heating:
                heat = heat + nu_shock * shock * divu * divu
            ts.diffus(nu_shock * shock)
        if nu_hyper3 > 0.0:
            fvisc = fvisc + nu_hyper3 * pen.del6v_scaled("uu")
            ts.diffus3(nu_hyper3)
        nu_mesh = self.mesh_coefficient()
        if nu_mesh > 0.0:
            d1 = pen.dline_1()
            fvisc = fvisc + nu_mesh * PI5_1 * sum(
                pen.d6_raw("uu", a) * d1[a] / 60.0 for a in range(3))
            ts.advec_mesh(nu_mesh * PI5_1 * torch.sqrt(
                d1[0] ** 2 + d1[1] ** 2 + d1[2] ** 2))
        if not isinstance(fvisc, float):
            accumulate(df, "uu", fvisc)
        if not isinstance(heat, float):
            pen._cache["visc_heat"] = heat
