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

import numpy as np
import torch


def _sstep(z, z0, w, tanh=torch.tanh):
    """Smooth step 0 → 1 at z0 over width w."""
    if w <= 0:
        return torch.where(z > z0, 1.0, 0.0)
    return 0.5 * (1.0 + tanh((z - z0) / w))


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


# The float32 tanh of the JAX package on the CPU (XLA's, Eigen's rational
# approximation with FMAs: p(x)/q(x) on x clamped to ±7.998811721801758,
# x itself below 4e-4), for K(z): 'K-profile''s dK/dz is a difference over
# 1e-3·Δz, which turns one ulp of K into ~1e-5 of dK/dz, as much as the
# parity bound allows; with the same tanh K is JAX's bit for bit.  Each
# operation runs in float64 and rounds to float32 (a product and a
# quotient of floats round once so; an FMA as its float64 sum rounds)
_TANH_P = (-2.76076847742355e-16, 2.00018790482477e-13,
           -8.60467152213735e-11, 5.12229709037114e-08,
           1.48572235717979e-05, 6.37261928875436e-04,
           4.89352455891786e-03)
_TANH_Q = (1.19825839466702e-06, 1.18534705686654e-04,
           2.26843463243900e-03, 4.89352518554385e-03)
_TANH_CLAMP = 7.99881172180175781


def _f32(x):
    return x.to(torch.float32).to(torch.float64)


def tanh_f32(x):
    """tanh of the float32 tensor ``x`` as the JAX package's CPU backend
    rounds it (float32)."""
    xd = torch.clamp(x.to(torch.float64), -_TANH_CLAMP, _TANH_CLAMP)
    x2 = _f32(xd * xd)

    def horner(coefs):
        acc = torch.full_like(x2, float(np.float32(coefs[0])))
        for c in coefs[1:]:
            acc = _f32(x2 * acc + float(np.float32(c)))
        return acc

    t = _f32(_f32(xd * horner(_TANH_P)) / horner(_TANH_Q))
    return torch.where(x.abs() < np.float32(0.0004), x,
                       t.to(x.dtype))


def hcond_profile(z, z1, z2, mpoly0, mpoly1, mpoly2, hcond0, width=0.05):
    """K(z) of 'K-profile' on the float32 tensor ``z``: constant in each
    polytropic layer with the ratios (m_i + 1)/(m0 + 1), which keep the
    conductive flux continuous across the layers (flux balance needs K ∝
    m + 1), blended across the interfaces with the step of ``width``
    (its tanh the JAX package's, ``tanh_f32``)."""
    k_bot = hcond0 * (mpoly1 + 1.0) / (mpoly0 + 1.0)
    k_mid = hcond0
    k_top = hcond0 * (mpoly2 + 1.0) / (mpoly0 + 1.0)
    s_lo = _sstep(z, z1, width, tanh_f32)
    s_hi = _sstep(z, z2, width, tanh_f32)
    return k_bot * (1 - s_lo) + k_mid * s_lo * (1 - s_hi) + k_top * s_hi


def cubic_step(x, x0, width, shift=0.0):
    """The reference's cubic_step (sub.f90): a smooth 0 → 1 step of half
    width ``width`` centred at x0 + shift·width."""
    xi = torch.clamp((x - x0) / max(width, 1e-30) - shift, -1.0, 1.0)
    return 0.5 + xi * (0.75 - xi * xi * 0.25)
