"""Piecewise-polytropic hydrostatic stratification (counterpart of
``pencil_tpu/physics/stratification.py``; reference ``'piecew-poly'`` in
src/density.f90 and src/entropy.f90, the conv-slab set-up).

Three layers in z under constant gravity gravz (< 0):
    [z0, z1]   stable underlayer, polytropic index mpoly1
    [z1, z2]   convectively unstable bulk, index mpoly0
    [z2, ztop] upper layer, index mpoly2 (isothermal if isothtop)
In a polytropic layer cs² is linear in z with slope γ·gravz/(mpoly+1) and
lnρ = lnρ_top + mpoly·ln(cs²/cs²_top); an isothermal layer has
dlnρ/dz = γ·gravz/cs².  The profiles are anchored at the top
(cs² = cs₀², lnρ = lnρ₀) and blended across the interfaces with a tanh
step of ``width``.  The entropy follows from the EOS.  The arithmetic is
the JAX package's, op for op in float32.
"""
from __future__ import annotations

import torch


def _sstep(z, z0, w):
    """Smooth step 0 → 1 at z0 over width w."""
    if w <= 0:
        return torch.where(z > z0, 1.0, 0.0)
    return 0.5 * (1.0 + torch.tanh((z - z0) / w))


def piecew_poly_profiles(z, spec, eos, gravz, z1, z2, mpoly0=1.0,
                         mpoly1=3.0, mpoly2=0.0, isothtop=1, width=0.05):
    """(lnρ(z), s(z)) on the 1-D float32 tensor of z points ``z``."""
    gamma = eos.gamma
    cs20 = eos.cs20
    ztop = spec.z0 + spec.Lz

    def layer_down(cs2_top, lnrho_top, z_top, zpts, mpoly, isoth):
        """cs², lnρ at zpts, integrating down from the layer top."""
        if isoth:
            cs2 = cs2_top * torch.ones_like(zpts)
            lnrho = lnrho_top + gamma * gravz * (zpts - z_top) / cs2_top
        else:
            beta = gamma * gravz / (mpoly + 1.0)
            cs2 = torch.clamp_min(cs2_top + beta * (zpts - z_top), 1e-12)
            lnrho = lnrho_top + mpoly * torch.log(cs2 / cs2_top)
        return cs2, lnrho

    def at(zz):
        return torch.tensor([zz], dtype=z.dtype, device=z.device)

    cs2_t, lnrho_t = layer_down(cs20, eos.lnrho0, ztop, z, mpoly2,
                                bool(isothtop))
    cs2_z2, lnrho_z2 = layer_down(cs20, eos.lnrho0, ztop, at(z2), mpoly2,
                                  bool(isothtop))
    cs2_m, lnrho_m = layer_down(cs2_z2[0], lnrho_z2[0], z2, z, mpoly0, False)
    cs2_z1, lnrho_z1 = layer_down(cs2_z2[0], lnrho_z2[0], z2, at(z1),
                                  mpoly0, False)
    cs2_b, lnrho_b = layer_down(cs2_z1[0], lnrho_z1[0], z1, z, mpoly1, False)

    s_lo = _sstep(z, z1, width)   # 0 below z1, 1 above
    s_hi = _sstep(z, z2, width)   # 0 below z2, 1 above
    cs2 = cs2_b * (1 - s_lo) + cs2_m * s_lo * (1 - s_hi) + cs2_t * s_hi
    lnrho = (lnrho_b * (1 - s_lo) + lnrho_m * s_lo * (1 - s_hi)
             + lnrho_t * s_hi)
    g1 = (gamma - 1.0) / gamma
    ss = eos.cp * (torch.log(cs2 / cs20) / gamma - g1 * (lnrho - eos.lnrho0))
    return lnrho, ss
