"""Ideal-gas equation of state without an entropy slot (counterpart of
``EosIdealGas`` in ``pencil_tpu/physics/eos.py``):

    cs² = cs₀² · exp((γ−1)(lnρ − lnρ₀)),   exactly cs₀² when γ = 1.
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

    @property
    def cs20(self) -> float:
        return self.cs0 * self.cs0

    @property
    def lnrho0(self) -> float:
        return math.log(self.rho0)

    def cs2(self, pen):
        if self.gamma == 1.0:
            # exactly isothermal: cs² is a constant — no exp per point
            return torch.full_like(pen.lnrho(), self.cs20)
        return self.cs20 * torch.exp(
            (self.gamma - 1.0) * (pen.lnrho() - self.lnrho0))
