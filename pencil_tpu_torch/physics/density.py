"""Continuity equation in the log formulation (counterpart of the lnρ branch
of ``pencil_tpu/physics/density.py:113-157``):

    Dlnρ/Dt = −∇·u [+ Σ_a |u_a|δ⁶_a lnρ/(60Δ_a)]
              [+ D(∇²lnρ + |∇lnρ|²)]
              [+ D_sh(shock(∇²lnρ + |∇lnρ|²) + ∇shock·∇lnρ)]
              [+ D₃ Σ_a ∂⁶lnρ/∂x_a⁶]
              [+ D₃ᵐ·π⁻⁵ Σ_a δ⁶_a lnρ·dline_1_a/60]

with 5th-order upwinding of the advection (``lupw_lnrho``, :113), Fickian
mass diffusion (``diffrho``, :120-125, its constant rate D), shock
diffusion (``diffrho_shock``, :126-136; it acts only where the Shock
module's slot exists), the 'simplified' hyper-diffusion of lnρ
(:137-149) and its mesh flavour (``diffrho_hyper3_mesh``, :150-156),
whose rate joins the advective CFL (``advec_mesh``).  The JAX module's
non-log density and its other hyper-diffusion flavours are not ported:
the polar one raises, and so does the anisotropic one, which JAX's log
branch drops (it acts on ρ only, :94-102).  Initial
conditions: 'zero', 'gaussian-noise', 'piecew-poly' (:214-227) and
'isothermal', lnρ = lnρ0 − γΦ/cs0² in the gravity's potential Φ, with
an entropy field also the matching ss = −(cp − cv)(lnρ − lnρ0) as the
additive key '+ss' (:180-199), which ``Model.init_state`` adds to the
entropy module's own ss after the overrides, as JAX's does."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from .base import ModuleBase, accumulate
from .initcond import init_scalar
from .viscosity import PI5_1
from .stratification import piecew_poly_profiles

# the entropy inits that assign ss themselves, so Density 'isothermal'
# adds no '+ss' (JAX density.py:192-196)
ENTROPY_ASSIGNERS = frozenset(("isothermal", "const_ss", "polytropic",
                               "polytropic_simple", "piecew-poly", "5"))


@dataclass(frozen=True)
class Density(ModuleBase):
    name: ClassVar[str] = "density"

    lupw_lnrho: bool = False       # 5th-order upwinding of u·∇lnρ
    diffrho: float = 0.0           # Fickian mass diffusion D
    diffrho_shock: float = 0.0     # shock diffusion of lnρ (idiff='shock')
    diffrho_hyper3: float = 0.0    # del6 hyperdiffusion (simplified flavor)
    diffrho_hyper3_mesh: float = 0.0   # its mesh flavour
    init: str = "zero"
    ampl: float = 0.0
    width: float = 0.05
    # the JAX module's other hyper-diffusion flavours, not ported
    lhyper3_polar: bool = False
    diffrho_hyper3_aniso: tuple = (0.0, 0.0, 0.0)

    def __post_init__(self):
        if self.lhyper3_polar:
            raise NotImplementedError(
                "pencil_tpu_torch: Density lhyper3_polar (the polar "
                "hyper-diffusion needs curvilinear coordinates)")
        if any(self.diffrho_hyper3_aniso):
            raise NotImplementedError(
                "pencil_tpu_torch: Density diffrho_hyper3_aniso on lnrho "
                "(JAX's log-density branch drops it: only its non-log "
                "branch, on rho, has the term)")

    def register(self, reg):
        reg.register("lnrho", 1, "pde")

    def rhs(self, pen, df, ts):
        out = -pen.ugrad("lnrho", upwind=self.lupw_lnrho) - pen.divu()
        if self.diffrho > 0.0:
            # diffusion of ρ in lnρ form: D(∇²lnρ + |∇lnρ|²)
            gl = pen.glnrho()
            g2 = gl[0] ** 2 + gl[1] ** 2 + gl[2] ** 2
            out = out + self.diffrho * (pen.del2lnrho() + g2)
            ts.diffus(self.diffrho)
        if self.diffrho_shock > 0.0 and "shock" in pen.reg.slots:
            # D_sh·[shock·(∇²lnρ + |∇lnρ|²) + ∇shock·∇lnρ]
            shock = pen.field("shock")
            gshock = pen.grad("shock")
            gl = pen.glnrho()
            g2 = gl[0] ** 2 + gl[1] ** 2 + gl[2] ** 2
            gsgl = sum(gshock[a] * gl[a] for a in range(3))
            out = out + self.diffrho_shock * (
                shock * (pen.del2lnrho() + g2) + gsgl)
            ts.diffus(self.diffrho_shock * shock)
        if self.diffrho_hyper3 > 0.0:
            out = out + self.diffrho_hyper3 * pen.del6s_scaled("lnrho")
            ts.diffus3(self.diffrho_hyper3)
        if self.diffrho_hyper3_mesh > 0.0:
            d1 = pen.dline_1()
            out = out + self.diffrho_hyper3_mesh * PI5_1 * sum(
                pen.d6_raw("lnrho", a)[0] * d1[a] / 60.0 for a in range(3))
            ts.advec_mesh(self.diffrho_hyper3_mesh * PI5_1 * torch.sqrt(
                d1[0] ** 2 + d1[1] ** 2 + d1[2] ** 2))
        accumulate(df, "lnrho", out)

    def init_fields(self, grid, spec, generator, cfg=None):
        if self.init == "isothermal":
            # isothermal stratification (reference isothermal_density,
            # density.f90:3108-3175)
            eos = cfg.module("eos")
            grav = cfg.module("gravity")
            pot = grav.potential_field(grid, spec) if grav else 0.0
            ones = torch.ones(spec.shape, dtype=grid.z.dtype,
                              device=grid.z.device)
            lnrho = (eos.lnrho0 - eos.gamma * pot / eos.cs20) * ones
            out = {"lnrho": lnrho}
            ent = cfg.module("entropy")
            # the reference always sets ss here; skipped only where the
            # entropy init assigns (not adds) a profile of its own
            if ent is not None and ent.init not in ENTROPY_ASSIGNERS:
                out["+ss"] = -(eos.cp - eos.cv) * (lnrho - eos.lnrho0)
            return out
        if self.init == "piecew-poly":
            # the layers are the entropy module's (density.f90 piecew-poly)
            ent = cfg.module("entropy") if cfg else None
            grav = cfg.module("gravity") if cfg else None
            lnrho, _ = piecew_poly_profiles(
                grid.z, spec, cfg.module("eos"),
                gravz=grav.gravz if grav else -1.0,
                z1=ent.z1 if ent else 0.0, z2=ent.z2 if ent else 1.0,
                mpoly0=ent.mpoly0 if ent else 1.0,
                mpoly1=ent.mpoly1 if ent else 3.0,
                mpoly2=ent.mpoly2 if ent else 0.0,
                isothtop=ent.isothtop if ent else 1, width=self.width)
            return {"lnrho": lnrho[None, None, :] * torch.ones(
                spec.shape, dtype=lnrho.dtype, device=lnrho.device)}
        return {"lnrho": init_scalar(self.init, grid, spec, generator,
                                     ampl=self.ampl)}
