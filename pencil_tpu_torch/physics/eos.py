"""Ideal-gas equation of state (counterpart of ``EosIdealGas`` in
``pencil_tpu/physics/eos.py``):

    cs² = cs₀² · exp(γ s/cp + (γ−1)(lnρ − lnρ₀))   with an entropy slot,
    cs² = cs₀² · exp((γ−1)(lnρ − lnρ₀))            without one,
          exactly cs₀² when γ = 1;
    lnT = lnT₀ + γ s/cp + (γ−1)(lnρ − lnρ₀),  cs₀² = (γ−1) cp T₀.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import torch

from .base import ModuleBase


@dataclass(frozen=True)
class EosIdealGas(ModuleBase):
    name: ClassVar[str] = "eos"

    gamma: float = 5.0 / 3.0
    cs0: float = 1.0
    rho0: float = 1.0
    cp: float = 1.0

    @property
    def cs20(self) -> float:
        return self.cs0 * self.cs0

    @property
    def lnrho0(self) -> float:
        return math.log(self.rho0)

    @property
    def cv(self) -> float:
        return self.cp / self.gamma

    @property
    def lnTT0(self) -> float:
        # cs20 = (gamma-1)*cp*T0; for gamma -> 1 fall back to cs20/cp
        g1 = max(self.gamma - 1.0, 1e-8)
        return math.log(self.cs20 / (g1 * self.cp))

    def cs2(self, pen):
        if "ss" in pen.reg.slots:
            return self.cs20 * torch.exp(
                self.gamma / self.cp * pen.ss()
                + (self.gamma - 1.0) * (pen.lnrho() - self.lnrho0))
        if self.gamma == 1.0:
            # exactly isothermal: cs² is a constant — no exp per point
            return torch.full_like(pen.lnrho(), self.cs20)
        return self.cs20 * torch.exp(
            (self.gamma - 1.0) * (pen.lnrho() - self.lnrho0))

    def lnTT(self, pen):
        if "ss" in pen.reg.slots:
            return (self.lnTT0 + self.gamma / self.cp * pen.ss()
                    + (self.gamma - 1.0) * (pen.lnrho() - self.lnrho0))
        return torch.full_like(pen.lnrho(), self.lnTT0)
