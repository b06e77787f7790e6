"""Continuity equation in the log formulation (counterpart of the lnρ branch
of ``pencil_tpu/physics/density.py:113``):  Dlnρ/Dt = −∇·u."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

from .base import ModuleBase, accumulate
from .initcond import init_scalar


@dataclass(frozen=True)
class Density(ModuleBase):
    name: ClassVar[str] = "density"

    lupw_lnrho: bool = False
    init: str = "zero"
    ampl: float = 0.0

    def __post_init__(self):
        if self.lupw_lnrho:
            raise NotImplementedError("pencil_tpu_torch: lupw_lnrho")

    def register(self, reg):
        reg.register("lnrho", 1, "pde")

    def rhs(self, pen, df, ts):
        accumulate(df, "lnrho", -pen.ugrad("lnrho") - pen.divu())

    def init_fields(self, grid, spec, generator):
        return {"lnrho": init_scalar(self.init, grid, spec, generator,
                                     ampl=self.ampl)}
