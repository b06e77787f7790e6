"""Viscous force on Cartesian grids (counterpart of
``pencil_tpu/physics/viscosity.py:38-227``), the sum of the selected
flavours in the JAX order, whatever the order of ``ivisc``:

    'nu-const'                  ν(∇²u + ⅓∇∇·u + 2S·∇lnρ)
    'nu-simplified'             ν∇²u
    'rho-nu-const'              (ν/ρ)(∇²u + ⅓∇∇·u)
    'rho-nu-const-bulk'         (ζ/ρ)∇∇·u
    'hyper3_nu-const_aniso'     Σ_j ν₃ⱼ(∂⁶_j u_i + u_{i,j}∂_j lnρ)
    'nu-shock'                  ν_sh[shock(∇∇·u + ∇·u ∇lnρ) + ∇·u ∇shock]
    'shock-simple'              ν_sh(∇shock·∇u_i + shock ∇²u_i)
    'hyper3-simplified'         ν₃ Σ_a ∂⁶u/∂x_a⁶
    'hyper3-nu-const'           the same plus ν₃ Σ_a ∂⁵_a u ∂_a lnρ Δ_a⁻⁵
    'hyper3-rho-nu-const-symm'  (ν₃/ρ)(Σ_a ∂⁶_a u + grad5divu)
    'nu-cspeed' / 'nu-therm'    μ_T(∇²u + ⅓∇∇·u + 2S·∇lnρ + 2c S·∇lnT),
                                μ_T = ν T^c
    'hyper3-mesh'               ν₃ᵐ·π⁻⁵ Σ_a δ⁶_a u·dline_1_a/60, whose rate
                                ν₃ᵐ·π⁻⁵·√Σ_a dline_1_a² joins the advective
                                CFL (``advec_mesh``)

each under its JAX aliases (``ALIASES``), any of them optional.  With an
entropy slot the viscous heating (2νS², 2(ν/ρ)S², (ζ/ρ)(∇·u)²,
ν_sh·shock·(∇·u)², 2μ_T S²) goes into the pencil cache for the entropy
module (JAX viscosity.py:224-227).  'nu-mixture' (chemistry), the polar
flavours (curvilinear coordinates) and ``limplicit_viscosity`` raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Tuple

import torch

from ..integrate.timestep import pow6
from .base import ModuleBase, accumulate

# each flavour under its JAX names (viscosity.py:43-222); the del6 term of
# 'hyper3-simplified' is also that of 'hyper3-nu-const', which adds the
# 5th-derivative lnρ term
ALIASES = {
    "nu-const": ("nu-const",),
    "nu-simplified": ("simplified", "nu-simplified", "0"),
    "rho-nu-const": ("rho-nu-const", "rho_nu-const", "1"),
    "rho-nu-const-bulk": ("rho-nu-const-bulk",),
    "hyper3_nu-const_aniso": ("hyper3_nu-const_aniso",),
    "nu-shock": ("nu-shock", "shock"),
    "shock-simple": ("shock-simple", "shock_simple"),
    "hyper3-simplified": ("hyper3-simplified", "hyper3-nu-const",
                          "hyper3_nu-const"),
    "hyper3-nu-const": ("hyper3-nu-const", "hyper3_nu-const"),
    "hyper3-rho-nu-const-symm": ("hyper3_rho_nu-const_symm",
                                 "hyper3-rho-nu-const-symm"),
    "nu-cspeed": ("nu-cspeed", "nu-therm"),
    "hyper3-mesh": ("hyper3-mesh",),
}
# the JAX flavours that the port refuses on every device, with why
REFUSED = {
    "nu-mixture": "the chemistry module's transport data",
    "hyper3-sph": "curvilinear coordinates",
    "hyper3_sph": "curvilinear coordinates",
    "hyper3-cyl": "curvilinear coordinates",
    "hyper3_cyl": "curvilinear coordinates",
}
KNOWN = frozenset(n for names in ALIASES.values() for n in names)

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
    nu_cspeed: float = 0.5     # 'nu-cspeed' exponent (ν ∝ T^c)
    zeta: float = 0.0          # dynamic bulk viscosity ('rho-nu-const-bulk')
    nu_aniso_hyper3: tuple = (0.0, 0.0, 0.0)   # 'hyper3_nu-const_aniso'
    limplicit_viscosity: bool = False

    def __post_init__(self):
        iv = tuple(self.ivisc)
        refused = [n for n in iv if n in REFUSED]
        if refused:
            raise NotImplementedError(
                "pencil_tpu_torch: ivisc " + ", ".join(
                    f"{n!r} (needs {REFUSED[n]})" for n in refused))
        unknown = [n for n in iv if n not in KNOWN]
        if unknown or len(set(iv)) != len(iv):
            raise NotImplementedError(
                f"pencil_tpu_torch: ivisc={self.ivisc!r} (each once, of "
                f"{sorted(KNOWN)})")
        if self.limplicit_viscosity:
            raise NotImplementedError(
                "pencil_tpu_torch: Viscosity limplicit_viscosity (the "
                "implicit spectral step, integrate/implicit.py)")

    def selected(self, flavour):
        """Whether ``ivisc`` names ``flavour`` (a key of ALIASES) under
        any of its aliases."""
        return bool(set(ALIASES[flavour]) & set(self.ivisc))

    def terms(self):
        """Every flavour's coefficient, keyed as ALIASES, 0 (or zeros for
        the anisotropic ν₃ⱼ) where the flavour is off or adds nothing, as
        JAX's tests of each coefficient decide."""
        nu = max(self.nu, 0.0)
        nu3 = max(self.nu_hyper3, 0.0)
        nush = max(self.nu_shock, 0.0)
        aniso = tuple(float(c) for c in self.nu_aniso_hyper3)
        on = self.selected
        return {
            "nu-const": nu if on("nu-const") else 0.0,
            "nu-simplified": nu if on("nu-simplified") else 0.0,
            "rho-nu-const": nu if on("rho-nu-const") else 0.0,
            "rho-nu-const-bulk": (max(self.zeta, 0.0)
                                  if on("rho-nu-const-bulk") else 0.0),
            "hyper3_nu-const_aniso": (aniso if on("hyper3_nu-const_aniso")
                                      else (0.0, 0.0, 0.0)),
            "nu-shock": nush if on("nu-shock") else 0.0,
            "shock-simple": nush if on("shock-simple") else 0.0,
            "hyper3-simplified": nu3 if on("hyper3-simplified") else 0.0,
            "hyper3-nu-const": nu3 if on("hyper3-nu-const") else 0.0,
            "hyper3-rho-nu-const-symm": (
                nu3 if on("hyper3-rho-nu-const-symm") else 0.0),
            "nu-cspeed": nu if on("nu-cspeed") else 0.0,
            "hyper3-mesh": (max(self.nu_hyper3_mesh, 0.0)
                            if on("hyper3-mesh") else 0.0),
        }

    def coefficients(self):
        """(ν, ν_sh, ν₃) of 'nu-const', 'nu-shock' and the del6 term of
        'hyper3-simplified', with 0 for a flavour that is off."""
        t = self.terms()
        return t["nu-const"], t["nu-shock"], t["hyper3-simplified"]

    def mesh_coefficient(self):
        """ν₃ᵐ of 'hyper3-mesh', 0 where it contributes nothing."""
        return self.terms()["hyper3-mesh"]

    def rhs(self, pen, df, ts):
        t = self.terms()
        heating = "ss" in pen.reg.slots
        fvisc = 0.0
        heat = 0.0
        nu = t["nu-const"]
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
        nu_s = t["nu-simplified"]
        if nu_s > 0.0:
            # ν∇²u, no density factors; heat 2νS²
            fvisc = fvisc + nu_s * pen.del2u()
            if heating:
                heat = heat + 2.0 * nu_s * pen.sij2()
            ts.diffus(nu_s)
        nu_r = t["rho-nu-const"]
        if nu_r > 0.0:
            # constant dynamic viscosity: (ν/ρ)(∇²u + ⅓∇∇·u), heat
            # 2(ν/ρ)S², rate ν/ρ (ν·ρ⁻¹, as the kernels form it)
            murho1 = nu_r * pen.rho1()
            fvisc = fvisc + murho1[None] * (
                pen.del2u() + (1.0 / 3.0) * pen.graddivu())
            if heating:
                heat = heat + 2.0 * murho1 * pen.sij2()
            ts.diffus(murho1)
        zeta = t["rho-nu-const-bulk"]
        if zeta > 0.0:
            # bulk viscosity: (ζ/ρ)∇∇·u, heat (ζ/ρ)(∇·u)², rate ζ/ρ
            zetarho1 = zeta * pen.rho1()
            fvisc = fvisc + zetarho1[None] * pen.graddivu()
            if heating:
                heat = heat + zetarho1 * pen.divu() ** 2
            ts.diffus(zetarho1)
        nua = t["hyper3_nu-const_aniso"]
        if any(nua):
            # Σ_j ν₃ⱼ ∂⁶u_i/∂x_j⁶ + Σ_j u_{i,j}·∂_j lnρ·ν₃ⱼ, rate
            # Σ_j ν₃ⱼ dline_1_j⁶/Σ_j dline_1_j⁶
            uij = pen.uij()
            glnrho = pen.glnrho()
            fvisc = fvisc + torch.stack([
                sum(nua[a] * pen.d6_raw("uu", a)[i] * pow6(pen._inv(a))
                    + uij[i, a] * glnrho[a] * nua[a] for a in range(3))
                for i in range(3)])
            d1 = pen.dline_1()
            d16 = [pow6(d) for d in d1]
            ts.diffus3(sum(nua[a] * d16[a] for a in range(3))
                       / (d16[0] + d16[1] + d16[2]))
        nu_shock = t["nu-shock"]
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
        nu_ss = t["shock-simple"]
        if nu_ss > 0.0:
            # ν_sh·div(shock ∇u_i), no heating
            shock = pen.field("shock")
            gshock = pen.grad("shock")
            uij = pen.uij()
            del2u = pen.del2u()
            fvisc = fvisc + nu_ss * torch.stack([
                sum(gshock[j] * uij[i, j] for j in range(3))
                + shock * del2u[i] for i in range(3)])
            ts.diffus(nu_ss * shock)
        nu_hyper3 = t["hyper3-simplified"]
        if nu_hyper3 > 0.0:
            fvisc = fvisc + nu_hyper3 * pen.del6v_scaled("uu")
            if t["hyper3-nu-const"] > 0.0:
                # ν₃ Σ_a ∂⁵_a u·Δ_a⁻⁵·∂_a lnρ, the reference's uij5·∇lnρ
                # as JAX approximates it (viscosity.py:158-166)
                glnrho = pen.glnrho()
                fvisc = fvisc + nu_hyper3 * torch.stack([
                    sum(pen.d5_raw("uu", a)[i] * pen._inv(a) ** 5
                        * glnrho[a] for a in range(3))
                    for i in range(3)])
            ts.diffus3(nu_hyper3)
        nu_symm = t["hyper3-rho-nu-const-symm"]
        if nu_symm > 0.0:
            # (μ₃/ρ)(∇⁶u + ∇⁵(∇·u)), its rate μ₃ (JAX's bound)
            murho1 = nu_symm * pen.rho1()
            fvisc = fvisc + murho1 * (pen.del6v_scaled("uu")
                                      + pen.grad5divu())
            ts.diffus3(nu_symm)
        nu_t = t["nu-cspeed"]
        if nu_t > 0.0:
            # μ_T = ν·exp(c lnT): 2μS·∇lnρ + μ(∇²u + ⅓∇∇·u + 2c S·∇lnT),
            # heat 2μ_T S², rate μ_T
            muTT = nu_t * torch.exp(self.nu_cspeed * pen.lnTT())
            sij = pen.sij()
            glnrho = pen.glnrho()
            glnTT = pen.glnTT()
            sglnrho = torch.stack([
                sum(sij[a, b] * glnrho[b] for b in range(3))
                for a in range(3)])
            sglnTT = torch.stack([
                sum(sij[a, b] * glnTT[b] for b in range(3))
                for a in range(3)])
            fvisc = fvisc + muTT[None] * (
                pen.del2u() + (1.0 / 3.0) * pen.graddivu()
                + 2.0 * sglnrho + 2.0 * self.nu_cspeed * sglnTT)
            if heating:
                heat = heat + 2.0 * muTT * pen.sij2()
            ts.diffus(muTT)
        nu_mesh = t["hyper3-mesh"]
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
