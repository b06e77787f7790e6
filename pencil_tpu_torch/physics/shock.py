"""Artificial shock-viscosity profile (counterpart of the 'original'
variant of ``pencil_tpu/physics/shock.py:32-69``):

    shock = smooth( max₅( max(0, −∇·u) ) ) · Δx_min²

stored as a communicated auxiliary slot.  The model builds it in a
pre-pass before each RHS evaluation, with its own ghost fill (reference
calc_shock_profile, src/equ.f90:211).  Consumers: Viscosity('nu-shock').
The 'highorder' variant and the JAX module's switches of the max filter,
the divergence power and |∇·u| are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from ..ops.smooth import max_filter, smooth_binomial
from .base import ModuleBase


@dataclass(frozen=True)
class Shock(ModuleBase):
    name: ClassVar[str] = "shock"

    variant: str = "original"     # 'original' (shock.f90) only

    def __post_init__(self):
        if self.variant != "original":
            raise NotImplementedError(
                f"pencil_tpu_torch: Shock(variant={self.variant!r})")

    def register(self, reg):
        reg.register("shock", 1, "comm_aux")

    def compute_aux(self, pen, halo1):
        """pen: Pencils over the fully ghosted evolved fields; halo1(x)
        ghost-fills one interior scalar.  Returns {'shock': interior}."""
        g = pen.grid
        raw = torch.clamp_min(-pen.divu(), 0.0)
        # Δx_min² in f32 from the host copies of the inverse spacings
        m = [np.max(d) for d in (g.dx_1, g.dy_1, g.dz_1)]
        dxmin2 = np.float32(1.0) / np.maximum(
            m[0] * m[0], np.maximum(m[1] * m[1], m[2] * m[2]))
        filt = max_filter(halo1(raw), 2)
        return {"shock": smooth_binomial(filt) * float(dxmin2)}
