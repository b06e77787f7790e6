"""Induction equation for the vector potential A in the resistive gauge
(counterpart of ``pencil_tpu/physics/magnetic.py:181-254, :333-377``):

    ∂A/∂t = u×B + η∇²A + η₃ Σ_a ∂⁶A/∂x_a⁶ − η_sh·shock·J,
    du/dt += J×B/ρ   (µ₀ = 1)

with the anisotropic Alfvén CFL term Σ_a (B_a·dline_1_a)²/ρ.  ``B_ext``
is an imposed uniform field: B = ∇×A + B_ext (``Pencils.bb``, JAX
pencils.py:682-697), which u×B, J×B/ρ and the Alfvén speed read.  The
shock resistivity ``eta_shock`` (iresistivity 'eta-shock', JAX
magnetic.py:255-258) acts only where the Shock module's slot exists, with
its rate η_sh·shock in the CFL.  With an entropy slot the Ohmic heating
η J² goes into the pencil cache for the entropy module (``lohmic_heat``;
JAX magnetic.py:378-380), without the shock term.  The JAX module's other
options (Weyl gauge, the advective gauge, mean-field, Hall, ...) are not
ported: their fields do not exist here."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

from .base import ModuleBase, accumulate
from .initcond import init_vector


@dataclass(frozen=True)
class Magnetic(ModuleBase):
    name: ClassVar[str] = "magnetic"

    eta: float = 0.0
    eta_hyper3: float = 0.0
    eta_shock: float = 0.0     # shock resistivity (iresistivity 'eta-shock')
    lohmic_heat: bool = True
    init: str = "zero"
    ampl: float = 0.0
    B_ext: tuple = (0.0, 0.0, 0.0)

    def register(self, reg):
        reg.register("aa", 3, "pde", comps=("ax", "ay", "az"))

    def rhs(self, pen, df, ts):
        out = pen.uxb()
        if self.eta > 0.0:
            out = out + self.eta * pen.del2a()
            ts.diffus(self.eta)
        if self.eta_hyper3 > 0.0:
            out = out + self.eta_hyper3 * pen.del6v_scaled("aa")
            ts.diffus3(self.eta_hyper3)
        if self.eta_shock > 0.0 and "shock" in pen.reg.slots:
            shock = pen.field("shock")
            out = out - self.eta_shock * shock[None] * pen.jj()
            ts.diffus(self.eta_shock * shock)
        accumulate(df, "aa", out)
        bb = pen.bb()
        d1 = pen.dline_1()
        ts.advec2(sum((bb[a] * d1[a]) ** 2 for a in range(3)) * pen.rho1())
        accumulate(df, "uu", pen.jxbr())
        if self.lohmic_heat and self.eta > 0.0 and "ss" in pen.reg.slots:
            pen._cache["ohmic_heat"] = self.eta * pen.j2()

    def init_fields(self, grid, spec, generator, cfg=None):
        return {"aa": init_vector(self.init, grid, spec, generator,
                                  ampl=self.ampl)}
