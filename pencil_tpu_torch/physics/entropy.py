"""Entropy equation (counterpart of the subset of
``pencil_tpu/physics/entropy.py`` that stratified convection and
non-isothermal turbulence read; reference src/entropy.f90 ``denergy_dt``):

    Ds/Dt = −u·∇s [+ Σ_a |u_a|δ⁶_a s/(60Δ_a)] + (K/ρ)(∇²lnT + |∇lnT|²)
            + cp·χ·(∇²lnT + ∇lnT·(∇lnT + ∇lnρ))
            + χ_sh·(shock(∇²lnT + (∇lnρ + ∇lnT)·∇lnT) + ∇shock·∇lnT)
            + 2νS²/T + ηJ²/(ρT)
            − cool·p_c(z)·(cs² − cs²_cool)/(cs²_cool·ρT) + L·p_h(z)/(N·ρT)

with 5th-order upwinding of the advection (``lupw_ss``), constant
conductivity K ('K-const', its CFL rate χ = Kγ/(ρcp) per point), constant
thermal diffusivity χ ('chi-const', CFL rate χγ), shock heat conduction
('shock' with ``chi_shock``, CFL rate γχ_sh·shock; it acts only where the
Shock module's slot exists, JAX entropy.py:230-241), viscous heating
published by Viscosity, Ohmic heating published by Magnetic, a gaussian
cooling layer at the top and a volume-normalized gaussian heating layer
at the bottom.
The layer profiles depend on z alone; ``heat_cool_profiles`` computes them
once per model, so the plain version and the kernel read the same f32
vectors.  Every other option of the JAX module raises or has no field.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar, Tuple

import torch

from .base import ModuleBase, accumulate
from .initcond import init_scalar
from .stratification import piecew_poly_profiles


@dataclass(frozen=True)
class Entropy(ModuleBase):
    name: ClassVar[str] = "entropy"

    iheatcond: Tuple[str, ...] = ("K-const",)
    hcond0: float = 0.0        # K for 'K-const'
    chi: float = 0.0           # χ for 'chi-const'
    chi_shock: float = 0.0     # χ_sh for 'shock'
    lupw_ss: bool = False      # 5th-order upwinding of u·∇s
    luminosity: float = 0.0    # bottom heating layer
    wheat: float = 0.1
    cool: float = 0.0          # top cooling layer
    wcool: float = 0.2
    cs2cool: float = 0.0
    zcool: float = 0.0         # cooling layer centre (0: the top boundary)
    cooling_profile: str = "gaussian"
    mpoly0: float = 1.0        # piecewise-polytrope stratification
    mpoly1: float = 3.0
    mpoly2: float = 0.0
    z1: float = 0.0
    z2: float = 1.0
    isothtop: int = 1
    init: str = "zero"
    ampl: float = 0.0
    width: float = 0.05

    def __post_init__(self):
        if not set(self.iheatcond) <= {"K-const", "chi-const", "shock"}:
            raise NotImplementedError(
                f"pencil_tpu_torch: iheatcond={self.iheatcond!r} "
                "(only K-const, chi-const and shock)")
        if self.cooling_profile != "gaussian":
            raise NotImplementedError(
                f"pencil_tpu_torch: cooling_profile="
                f"{self.cooling_profile!r} (only gaussian)")

    def register(self, reg):
        reg.register("ss", 1, "pde")

    @property
    def conduction(self) -> bool:
        return "K-const" in self.iheatcond and self.hcond0 > 0.0

    @property
    def chi_conduction(self) -> bool:
        return "chi-const" in self.iheatcond and self.chi > 0.0

    def shock_conduction(self, reg) -> bool:
        """'shock' conduction on, in a layout with the shock slot."""
        return ("shock" in self.iheatcond and self.chi_shock > 0.0
                and "shock" in reg.slots)

    def cs2c(self, eos) -> float:
        """The cooling target: cs2cool, or cs20 when it is 0."""
        return self.cs2cool if self.cs2cool != 0.0 else eos.cs20

    def heat_norm(self, spec) -> float:
        """L over the layer's volume integral (entropy.f90:6222-6231)."""
        hnorm = (2.0 * math.pi) ** 0.5 / 2.0 * self.wheat * spec.Lx
        if spec.ny > 1:
            hnorm = hnorm * spec.Ly
        return self.luminosity / hnorm

    def heat_cool_profiles(self, z, spec):
        """(cooling profile, heating profile) on the interior z vector,
        float32 in the plain version's op order; None where off."""
        prof_c = prof_h = None
        if self.cool != 0.0:
            ztop = spec.z0 + spec.Lz
            zref = self.zcool if self.zcool != 0.0 else ztop
            prof_c = torch.exp(-0.5 * ((z - zref) / self.wcool) ** 2)
        if self.luminosity != 0.0:
            prof_h = torch.exp(-0.5 * ((z - spec.z0) / self.wheat) ** 2)
        return prof_c, prof_h

    def rhs(self, pen, df, ts):
        eos = pen.eos
        out = -pen.ugrad("ss", upwind=self.lupw_ss)
        glnTT = pen.glnTT()
        glnTT2 = glnTT[0] ** 2 + glnTT[1] ** 2 + glnTT[2] ** 2
        if self.conduction:
            # (1/ρT)∇·(K∇T) = (K/ρ)(∇²lnT + |∇lnT|²)
            out = out + self.hcond0 * pen.rho1() * (pen.del2lnTT() + glnTT2)
            ts.diffus(self.hcond0 * pen.rho1() / eos.cp * eos.gamma)
        if self.chi_conduction:
            glnrho = pen.glnrho()
            gdot = sum(glnTT[a] * (glnTT[a] + glnrho[a]) for a in range(3))
            out = out + eos.cp * self.chi * (pen.del2lnTT() + gdot)
            ts.diffus(self.chi * eos.gamma)
        if self.shock_conduction(pen.reg):
            # χ_sh·[shock·(∇²lnT + (∇lnρ+∇lnT)·∇lnT) + ∇shock·∇lnT]
            shock = pen.field("shock")
            gshock = pen.grad("shock")
            glnrho = pen.glnrho()
            g2 = sum((glnrho[a] + glnTT[a]) * glnTT[a] for a in range(3))
            gsglnTT = sum(gshock[a] * glnTT[a] for a in range(3))
            out = out + self.chi_shock * (
                shock * (pen.del2lnTT() + g2) + gsglnTT)
            ts.diffus(eos.gamma * self.chi_shock * shock)
        # viscous and Ohmic heating published by those modules
        heat = pen._cache.get("visc_heat")
        if heat is not None:
            out = out + heat * pen.TT1()
        ohm = pen._cache.get("ohmic_heat")
        if ohm is not None:
            out = out + ohm * pen.rho1() * pen.TT1()
        gs = pen.cfg.grid
        prof_c, prof_h = self.heat_cool_profiles(pen.grid.zg, gs)
        if prof_c is not None:
            cs2c = self.cs2c(eos)
            out = out - pen.rho1() * pen.TT1() \
                * self.cool * prof_c * (pen.cs2() - cs2c) / cs2c
        if prof_h is not None:
            out = out + self.heat_norm(gs) * prof_h * pen.rho1() * pen.TT1()
        accumulate(df, "ss", out)

    def init_fields(self, grid, spec, generator, cfg=None):
        if self.init == "piecew-poly":
            grav = cfg.module("gravity") if cfg else None
            _, ss = piecew_poly_profiles(
                grid.z, spec, cfg.module("eos"),
                gravz=grav.gravz if grav else -1.0,
                z1=self.z1, z2=self.z2, mpoly0=self.mpoly0,
                mpoly1=self.mpoly1, mpoly2=self.mpoly2,
                isothtop=self.isothtop, width=self.width)
            return {"ss": ss[None, None, :] * torch.ones(
                spec.shape, dtype=ss.dtype, device=ss.device)}
        return {"ss": init_scalar(self.init, grid, spec, generator,
                                  ampl=self.ampl)}
