"""Entropy equation (counterpart of the subset of
``pencil_tpu/physics/entropy.py`` that stratified convection and
non-isothermal turbulence read; reference src/entropy.f90 ``denergy_dt``):

    Ds/Dt = −u·∇s [+ Σ_a |u_a|δ⁶_a s/(60Δ_a)]
            + (heat_uniform − cool_uniform·ρ·cp·T)/(ρT)
            + (K/ρ)(∇²lnT + |∇lnT|²)
            + (K(z)/ρ)(∇²lnT + |∇lnT|²) + (K′(z)/ρ)∂_z lnT
            + (K_kr/ρ)(∇²lnT + Σ_a (−2n∂_a lnρ + (6.5n + 1)∂_a lnT)∂_a lnT)
            + cp·χT^c·(∇²lnT + Σ_a (∂_a lnρ + (1 + c)∂_a lnT)∂_a lnT)
            + cp·χ·(∇²lnT + ∇lnT·(∇lnT + ∇lnρ))
            + χ_sh·(shock(∇²lnT + (∇lnρ + ∇lnT)·∇lnT) + ∇shock·∇lnT)
            + χ₃ Σ_a ∂⁶s/∂x_a⁶ + Σ_a χ₃ₐ∂⁶s/∂x_a⁶
            − cp(T − T_ref)/(γτT)
            + χ₃ᵐπ⁻⁵ Σ_a δ⁶_a s·dline_1_a/60
            + 2νS²/T + ηJ²/(ρT)
            − cool·p_c(z)·(cs² − cs²_cool)/(cs²_cool·ρT) + L·p_h(z)/(N·ρT)

in JAX's order of the terms: 5th-order upwinding of the advection
(``lupw_ss``), uniform volumetric heating and cooling (``heat_uniform``,
``cool_uniform``), constant conductivity K ('K-const', its CFL rate
Kγ/(ρcp) per point), the layered conductivity K(z) of 'K-profile' (K ∝
m + 1 in each polytropic layer, ``hcond_z``; rate K(z)γ/(ρcp)), Kramers
opacity ('kramers': K_kr/ρ = K₀ρ^(−2n−1)T^(6.5n), optionally clipped to
[χ_min, χ_max]·cp; rate K_kr γ/(ρcp)), temperature-dependent diffusivity
('chi-cspeed' or 'chi-therm': χT^c with c = ``chi_cspeed``; rate γχT^c),
constant thermal diffusivity χ ('chi-const', CFL rate χγ), shock heat
conduction ('shock' with ``chi_shock``, CFL rate γχ_sh·shock; it acts
only where the Shock module's slot exists, JAX entropy.py:230-241),
the del6 hyper-diffusion of s (``chi_hyper3``, Δ_a⁻⁶-scaled, its rate χ₃
a hyper-diffusivity), its anisotropic flavour (``chi_hyper3_aniso``, χ₃ₐ
per axis, rate Σ_a χ₃ₐ dline_1_a⁶/Σ_a dline_1_a⁶), Newtonian cooling
towards ``TTref_cool`` on the time ``tau_cool``, the mesh flavour of the
hyper-diffusion (``chi_hyper3_mesh``, whose rate χ₃ᵐπ⁻⁵√Σ dline_1²
joins the advective CFL; JAX entropy.py:242-279; the polar flavours
raise), viscous heating published by Viscosity, Ohmic heating published by
Magnetic, a cooling layer (``cooling_profile``: a gaussian at the top or
``zcool``, a tanh step at z2 ('step') or at ``zcool`` ('step2'), a cubic
step at z2 ('cubic_step') or z/wcool ('lin-z')) and a volume-normalized
gaussian heating layer at the bottom.
The layer profiles and K(z) depend on z alone; ``heat_cool_profiles``
and ``hcond_z`` compute them once per model, so the plain version and the
kernel read the same f32 vectors.  Every other option of the JAX module
raises or has no field.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar, Tuple

import numpy as np
import torch

from ..integrate.timestep import pow6
from .base import ModuleBase, accumulate
from .initcond import init_scalar
from .stratification import (cubic_step, hcond_profile,
                             piecew_poly_profiles)
from .viscosity import PI5_1


# the conduction flavours and the cooling-layer shapes that are ported
# ('K-profile' from mpoly0-2 and hcond0; its table form, lread_hcond,
# needs gravx and is not); the names of the hyper-diffusion flavours
# (reference entropy.f90 initialize_energy), whose terms follow their
# coefficients, as JAX's do
HEATCOND = frozenset(("K-const", "K-profile", "kramers", "chi-const",
                      "chi-cspeed", "chi-therm", "shock", "hyper3",
                      "hyper3_ss", "hyper3-aniso", "hyper3_aniso",
                      "hyper3-mesh", "hyper3_mesh"))
# the polar flavours of the hyper-diffusion (JAX entropy.py:244-254)
POLAR_HYPER3 = frozenset(("hyper3-sph", "hyper3_sph", "hyper3-cyl",
                          "hyper3_cyl"))
COOLING_PROFILES = ("gaussian", "step", "step2", "cubic_step", "lin-z")


@dataclass(frozen=True)
class Entropy(ModuleBase):
    name: ClassVar[str] = "entropy"

    iheatcond: Tuple[str, ...] = ("K-const",)
    hcond0: float = 0.0        # K for 'K-const'
    chi: float = 0.0           # χ for 'chi-const'
    chi_shock: float = 0.0     # χ_sh for 'shock'
    chi_hyper3: float = 0.0    # χ₃ of the del6 hyper-diffusion of s
    chi_hyper3_mesh: float = 0.0   # its mesh flavour χ₃ᵐ
    chi_hyper3_aniso: tuple = (0.0, 0.0, 0.0)  # its anisotropic χ₃ₐ
    hcond0_kramers: float = 0.0    # K₀ of 'kramers'
    nkramers: float = 1.0          # its exponent n
    chimax_kramers: float = 0.0    # its clip [χ_min, χ_max]·cp (χ_max > 0)
    chimin_kramers: float = 0.0
    chi_cspeed: float = 0.5    # the exponent c of 'chi-cspeed' (χT^c)
    tau_cool: float = 0.0      # Newtonian cooling towards TTref_cool
    TTref_cool: float = 0.0
    heat_uniform: float = 0.0  # uniform volumetric heating and cooling
    cool_uniform: float = 0.0
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
    # the flux walls 'Fgs'/'Fct' alone read these (the RHS does not):
    # σ_SBt of the black-body wall, the turbulent χ_t with its profile
    # factor at each wall, K at each wall (Kramers' K adds to it in
    # 'Fgs' and replaces it in 'Fct') and the total flux of 'Fct'
    sigmaSBt: float = 0.0
    chi_t: float = 0.0
    chit_prof1: float = 1.0
    chit_prof2: float = 1.0
    hcondbot: float = 0.0
    hcondtop: float = 0.0
    Fbot: float = 0.0
    Ftop: float = 0.0
    init: str = "zero"
    ampl: float = 0.0
    width: float = 0.05

    def __post_init__(self):
        polar = sorted(POLAR_HYPER3 & set(self.iheatcond))
        if polar:
            raise NotImplementedError(
                f"pencil_tpu_torch: Entropy iheatcond {polar} (the polar "
                "hyper-diffusion of s needs curvilinear coordinates)")
        if not set(self.iheatcond) <= HEATCOND:
            raise NotImplementedError(
                f"pencil_tpu_torch: iheatcond={self.iheatcond!r} "
                f"(only {', '.join(sorted(HEATCOND))})")
        if self.cooling_profile not in COOLING_PROFILES:
            raise NotImplementedError(
                f"pencil_tpu_torch: cooling_profile="
                f"{self.cooling_profile!r} (only "
                f"{', '.join(COOLING_PROFILES)})")

    def register(self, reg):
        reg.register("ss", 1, "pde")

    @property
    def conduction(self) -> bool:
        return "K-const" in self.iheatcond and self.hcond0 > 0.0

    @property
    def chi_conduction(self) -> bool:
        return "chi-const" in self.iheatcond and self.chi > 0.0

    @property
    def kprofile(self) -> bool:
        """'K-profile' on: K(z) from the polytropic layers, scale hcond0."""
        return "K-profile" in self.iheatcond and self.hcond0 > 0.0

    @property
    def kramers(self) -> bool:
        return "kramers" in self.iheatcond and self.hcond0_kramers > 0.0

    @property
    def cspeed_conduction(self) -> bool:
        """'chi-cspeed' (or its other name 'chi-therm') on: χT^c."""
        return bool({"chi-cspeed", "chi-therm"} & set(self.iheatcond)) \
            and self.chi > 0.0

    def hcond_z(self, grid):
        """(K(z), dK/dz(z)) of 'K-profile' on the interior z, float32 in
        JAX's op order (entropy.py:169-176): dK/dz a one-sided difference
        with the step 1e-3·min Δz."""
        def prof(z):
            return hcond_profile(z, self.z1, self.z2, self.mpoly0,
                                 self.mpoly1, self.mpoly2, self.hcond0,
                                 self.width)
        f32 = np.float32
        dz = torch.tensor(f32(1e-3) * (f32(1.0) / np.max(grid.dz_1)),
                          dtype=grid.z.dtype, device=grid.z.device)
        K = prof(grid.z)
        return K, (prof(grid.z + dz) - K) / dz

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
            shape = self.cooling_profile
            w = max(self.wcool, 1e-30)
            if shape == "step":
                prof_c = 0.5 * (1.0 + torch.tanh((z - self.z2) / w))
            elif shape == "step2":
                prof_c = 0.5 * (1.0 + torch.tanh((z - self.zcool) / w))
            elif shape == "cubic_step":
                prof_c = cubic_step(z, self.z2, self.wcool)
            elif shape == "lin-z":
                prof_c = z / w
            else:
                ztop = spec.z0 + spec.Lz
                zref = self.zcool if self.zcool != 0.0 else ztop
                prof_c = torch.exp(-0.5 * ((z - zref) / self.wcool) ** 2)
        if self.luminosity != 0.0:
            prof_h = torch.exp(-0.5 * ((z - spec.z0) / self.wheat) ** 2)
        return prof_c, prof_h

    def rhs(self, pen, df, ts):
        eos = pen.eos
        out = -pen.ugrad("ss", upwind=self.lupw_ss)
        if self.heat_uniform != 0.0 or self.cool_uniform != 0.0:
            heat_u = (self.heat_uniform
                      - self.cool_uniform * pen.rho() * eos.cp * pen.TT())
            out = out + heat_u * pen.rho1() * pen.TT1()
        glnTT = pen.glnTT()
        glnTT2 = glnTT[0] ** 2 + glnTT[1] ** 2 + glnTT[2] ** 2
        if self.conduction:
            # (1/ρT)∇·(K∇T) = (K/ρ)(∇²lnT + |∇lnT|²)
            out = out + self.hcond0 * pen.rho1() * (pen.del2lnTT() + glnTT2)
            ts.diffus(self.hcond0 * pen.rho1() / eos.cp * eos.gamma)
        if self.kprofile:
            # (1/ρT)∇·(K(z)∇T) = (K/ρ)(∇²lnT + |∇lnT|²) + (K′/ρ)∂_z lnT
            K, dKdz = self.hcond_z(pen.grid)
            out = out + pen.rho1() * (
                K * (pen.del2lnTT() + glnTT2) + dKdz * glnTT[2])
            ts.diffus(K * pen.rho1() / eos.cp * eos.gamma)
        if self.kramers:
            # K_kr/ρ = K₀ρ^(−2n−1)T^(6.5n), clipped to [χ_min, χ_max]·cp
            n_ = self.nkramers
            Krho1 = self.hcond0_kramers * torch.exp(
                -(2.0 * n_ + 1.0) * pen.lnrho() + (6.5 * n_) * pen.lnTT())
            if self.chimax_kramers > 0.0:
                Krho1 = torch.clamp(Krho1, self.chimin_kramers * eos.cp,
                                    self.chimax_kramers * eos.cp)
            glnrho = pen.glnrho()
            g2 = sum((-2.0 * n_ * glnrho[a] + (6.5 * n_ + 1.0) * glnTT[a])
                     * glnTT[a] for a in range(3))
            out = out + Krho1 * (pen.del2lnTT() + g2)
            ts.diffus(Krho1 / eos.cp * eos.gamma)
        if self.cspeed_conduction:
            # χ_eff = χT^c: cp·χ_eff(∇²lnT + (∇lnρ + (1 + c)∇lnT)·∇lnT)
            thchi = self.chi * torch.exp(self.chi_cspeed * pen.lnTT())
            glnrho = pen.glnrho()
            g2 = sum((glnrho[a] + (1.0 + self.chi_cspeed) * glnTT[a])
                     * glnTT[a] for a in range(3))
            out = out + thchi * (pen.del2lnTT() + g2) * eos.cp
            ts.diffus(eos.gamma * thchi)
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
        if self.chi_hyper3 > 0.0:
            out = out + self.chi_hyper3 * pen.del6s_scaled("ss")
            ts.diffus3(self.chi_hyper3)
        chia = self.chi_hyper3_aniso
        if any(c != 0.0 for c in chia):
            # Σ_a χ₃ₐ∂⁶s/∂x_a⁶, rate Σ_a χ₃ₐdline_1_a⁶/Σ_a dline_1_a⁶
            out = out + sum(chia[a] * pen.d6_raw("ss", a)[0]
                            * pow6(pen._inv(a)) for a in range(3))
            d16 = [pow6(d) for d in pen.dline_1()]
            ts.diffus3(sum(chia[a] * d16[a] for a in range(3))
                       / (d16[0] + d16[1] + d16[2]))
        if self.tau_cool != 0.0:
            # heat = −ρcp(T − T_ref)/(γτ), so ds/dt −= cp(T − T_ref)/(γτT)
            TT = pen.TT()
            out = out - eos.cp / eos.gamma * (TT - self.TTref_cool) \
                / (self.tau_cool * TT)
        if self.chi_hyper3_mesh > 0.0:
            d1 = pen.dline_1()
            out = out + self.chi_hyper3_mesh * PI5_1 * sum(
                pen.d6_raw("ss", a)[0] * d1[a] / 60.0 for a in range(3))
            ts.advec_mesh(self.chi_hyper3_mesh * PI5_1 * torch.sqrt(
                d1[0] ** 2 + d1[1] ** 2 + d1[2] ** 2))
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
