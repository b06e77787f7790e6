"""Artificial shock-viscosity profile (counterpart of
``pencil_tpu/physics/shock.py``, every switch of it):

    shock = smooth( max₅( max(0, −∇·u) ) ) · Δx_min²

stored as a communicated auxiliary slot.  The model builds it in a
pre-pass before each RHS evaluation, with its own ghost fill (reference
calc_shock_profile, src/equ.f90:211).  Consumers: Viscosity('nu-shock')
and the shock diffusivities of Density, Magnetic and Entropy.  The
'highorder' variant (reference shock_highorder.f90) takes the maximum over
±``ishock_max`` along each axis with more than one point and smooths with
7 points (binomial or, with ``lgaussian_smooth``, 'gaussian' weights).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from ..ops.smooth import max_filter, max_filter_axes, smooth_7pt, \
    smooth_binomial
from ..ops.stencil import NGHOST
from .base import ModuleBase

VARIANTS = ("original", "highorder")


@dataclass(frozen=True)
class Shock(ModuleBase):
    name: ClassVar[str] = "shock"

    lmax_shock: bool = True       # apply the max-filter stage
    shock_div_pow: float = 1.0    # a power on the rectified divergence
    variant: str = "original"     # 'original' (shock.f90) | 'highorder'
    ishock_max: int = 1           # 'highorder': the max filter's radius
    lgaussian_smooth: bool = False
    lconvergence_only: bool = True   # max(0, −∇·u); False: |∇·u|

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise NotImplementedError(
                f"pencil_tpu_torch: Shock(variant={self.variant!r}) "
                f"(ported: {VARIANTS})")
        if self.variant == "highorder" and not 1 <= self.ishock_max \
                <= NGHOST:
            raise NotImplementedError(
                f"pencil_tpu_torch: Shock(ishock_max={self.ishock_max}) "
                f"(the ghost width {NGHOST} bounds the radius)")

    def register(self, reg):
        reg.register("shock", 1, "comm_aux")

    def compute_aux(self, pen, halo1):
        """pen: Pencils over the fully ghosted evolved fields; halo1(x)
        ghost-fills one interior scalar.  Returns {'shock': interior}."""
        g = pen.grid
        divu = pen.divu()
        raw = torch.clamp_min(-divu, 0.0) if self.lconvergence_only \
            else torch.abs(divu)
        if self.shock_div_pow != 1.0:
            raw = raw ** self.shock_div_pow
        # Δx_min² in f32 from the host copies of the inverse spacings
        m = [np.max(d) for d in (g.dx_1, g.dy_1, g.dz_1)]
        dxmin2 = float(np.float32(1.0) / np.maximum(
            m[0] * m[0], np.maximum(m[1] * m[1], m[2] * m[2])))
        if self.variant == "highorder":
            # the max over ±r along each axis with more than one point,
            # cropped to the interior, re-filled, then smoothed with 7
            # points
            active = tuple(n > 1 for n in pen.cfg.grid.shape)
            r, gw = self.ishock_max, NGHOST
            filt = max_filter_axes(halo1(raw), r, active)
            c = gw - r
            filt = filt[c:filt.shape[0] - c, c:filt.shape[1] - c,
                        c:filt.shape[2] - c]
            sm = smooth_7pt(halo1(filt), active,
                            lgaussian=self.lgaussian_smooth)
            return {"shock": sm * dxmin2}
        rawg = halo1(raw)
        filt = max_filter(rawg, 2) if self.lmax_shock \
            else rawg[2:-2, 2:-2, 2:-2]
        return {"shock": smooth_binomial(filt) * dxmin2}
