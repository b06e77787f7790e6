"""Shearing box (counterpart of ``pencil_tpu/physics/shear.py:24-114``).

Co-moving formulation with background flow U₀ = S·x ŷ, S = −qΩ (Keplerian
q = 3/2), or S = ``Sshear`` where that is not 0 (pure shear, Ω = 0).
Every evolved field f gains −S x ∂f/∂y (advection by the background
shear), plus

    hydro:     duy/dt −= S·ux
    magnetic:  dAx/dt −= S·Ay

and the CFL gains |S x|/Δy.  The x boundary is shear-periodic,
f(x + Lx, y) = f(x, y − S·Lx·t): ``fill_ghosts`` shifts the x ghost slabs
in y by ±deltay with ``fourier_shift_y``, an exact Fourier shift over the
periodic y axis.

SAFI (``lshearadvection_as_shift``, the reference's advance_shear →
sheared_advection_fft, shear.f90:536-579; Johansen, Youdin & Klahr 2009,
ApJ 697, 1269) drops the −S x ∂f/∂y terms and their CFL term from the
RHS: the model shifts the evolved fields (and the 2N-RK df carry) by
``shift_advection`` after each substep instead, which is exact, so the
shear's |S x|/Δy no longer limits dt.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from ..ops.stencil import NGHOST
from .base import ModuleBase, accumulate

# −2π rounded to f32, the constant of the JAX package's phase product
_M2PI = float(np.float32(-2.0 * math.pi))


@dataclass(frozen=True)
class Shear(ModuleBase):
    name: ClassVar[str] = "shear"

    qshear: float = 1.5
    Omega: float = 1.0
    # the reference's Sshear: where not 0 it overrides −qshear·Omega
    # (shear.f90:96; pure-shear runs with Ω = 0)
    Sshear: float = 0.0
    lshearadvection_as_shift: bool = False

    @property
    def S(self) -> float:
        if self.Sshear != 0.0:
            return self.Sshear
        return -self.qshear * self.Omega

    def deltay(self, t, Lx, Ly):
        """The y offset of the shear-periodic x faces at time ``t`` (a
        device tensor), in the working precision on the device."""
        return torch.remainder(-self.S * Lx * t, Ly)

    def rhs(self, pen, df, ts):
        S = self.S
        if not self.lshearadvection_as_shift:
            uy0 = S * pen.grid.xg
            # advect every evolved field by the background flow: −uy0 ∂f/∂y
            for name, slot in pen.reg.slots.items():
                if slot.kind != "pde":
                    continue
                term = -uy0 * pen.d(name, 1)
                accumulate(df, name, term[0] if slot.ncomp == 1 else term)
            ts.advec(uy0.abs() * pen.dline_1()[1])
        if "uu" in pen.reg.slots:
            uu = pen.uu()
            zero = torch.zeros_like(uu[0])
            accumulate(df, "uu", torch.stack([zero, -S * uu[0], zero]))
        if "aa" in pen.reg.slots:
            aa = pen.aa()
            zero = torch.zeros_like(aa[0])
            accumulate(df, "aa", torch.stack([-S * aa[1], zero, zero]))


    def shift_advection(self, arr, grid, Ly, dtsub):
        """The interior fields ``arr`` (ncomp, nx, ny, nz) advected by the
        background flow over ``dtsub``, exactly: f(x, y) ← f(x, y − S·x·
        dtsub), a Fourier phase per x plane over the periodic y axis (JAX
        shear.py:84-95), as a new contiguous tensor on ``arr``'s device.  The phase
        is formed in f32 in the JAX package's order: uy0 = S·x, shift =
        uy0·dtsub, k = j/Ly, θ = (−2π·k)·shift; ``dtsub`` is a device
        scalar, so the shift never syncs."""
        ny = arr.shape[2]
        shift = (self.S * grid.x) * dtsub
        fk = torch.fft.rfft(arr, dim=2)
        k = torch.arange(ny // 2 + 1, dtype=arr.dtype,
                         device=arr.device) / (Ly / ny * ny)
        theta = (_M2PI * k)[None, :] * shift[:, None]
        phase = torch.complex(torch.cos(theta), torch.sin(theta))
        return _irfft_y(fk * phase[None, :, :, None], ny, 2).to(
            arr.dtype).contiguous()


def fourier_shift_y(slab, dy, Ly):
    """``slab`` (..., ny, nz) shifted by ``dy`` along its periodic y axis,
    as a new tensor.  The phase is formed in f32 in the JAX package's
    order, k = j/(Ly), θ = (−2π·k)·dy (shear.py:110-112): at 256³ θ
    reaches ~800 rad, where a phase formed in f64 differs by ~6e-5.  No
    host value is copied to the device, so the shift never syncs."""
    ny = slab.shape[-2]
    fk = torch.fft.rfft(slab, dim=-2)
    k = torch.arange(ny // 2 + 1, dtype=slab.dtype,
                     device=slab.device) / (Ly / ny * ny)
    theta = (_M2PI * k) * dy
    phase = torch.complex(torch.cos(theta), torch.sin(theta))
    return _irfft_y(fk * phase[:, None], ny, -2).to(slab.dtype)


def _irfft_y(spec, ny, dim):
    """The real field of ny points along ``dim`` whose rfft is ``spec`` (a
    new tensor, written in place), its Nyquist bin read as real where ny
    is even, as numpy's, pocketfft's and the JAX package's irfft read it:
    a shift makes that bin complex, and cuFFT's C2R reads its imaginary
    part too, from ny = 128 up (a shifted 256-row field then parts from
    the CPU's by 1e-2 of its max)."""
    if ny % 2 == 0:
        spec.narrow(dim, ny // 2, 1).imag.zero_()
    return torch.fft.irfft(spec, n=ny, dim=dim)


def shift_x_faces(fg, dy, Ly, y_ghosted, z_ghosted):
    """Shift the two x ghost slabs of ``fg`` (nc, mx, my, mz) in y by ±dy,
    in place, over the interior y rows (and interior z columns): the
    shear-periodic x boundary (JAX parallel/halo.py:112-152, one
    device)."""
    g = NGHOST
    mx, my, mz = fg.shape[-3:]
    ylo, ny = (g, my - 2 * g) if y_ghosted else (0, my)
    zlo, nz = (g, mz - 2 * g) if z_ghosted else (0, mz)
    for x0, d in ((0, dy), (mx - g, -dy)):
        slab = fg[..., x0:x0 + g, ylo:ylo + ny, zlo:zlo + nz]
        slab.copy_(fourier_shift_y(slab, d, Ly))
