"""Stochastic helical k-shell forcing (counterpart of
``pencil_tpu/physics/forcing.py:27-40, :195-255``; reference forcing_hel,
src/forcing.f90:1851-2259, applied once per full step).

Each step draws a wavevector index into the shell |k| ∈ [kf−dk, kf+dk], a
phase φ and a random direction e, and adds

    Δu = N·dt·Re[(f_re + i·f_im)·e^{i(k·x+φ)}],   N = force·cs₀·√(|k|cs₀/dt)

to u.  ``draw`` makes the three draws with a ``torch.Generator`` on the
model's device; a caller may supply them instead (``Model.forcing_draws``),
which is how the tests inject the JAX package's threefry draws.  Everything
after the draws is device tensor arithmetic, so a step needs no host sync.

Replay mode (``sequence`` set; JAX ``_replay``, pencil_tpu/physics/
forcing.py:130-193, reference fconst_coefs_hel, src/forcing.f90:1578-1730):
the run-directory loader records the reference's per-step draws (k,
phase, φ) from its own random stream; the row of step ``it`` (the last
row past the end) builds the separable helical eigenfunction, and the
kick is fact·Re[(coef1 + i·coef2)·e^{i(k·x+phase)}], the same form as
above with f_re = coef1, f_im = coef2 and N·dt = fact.  The table lives
on the device and the row is picked by the state's ``it`` tensor.

Continuous forcing (``lforcing_cont``; JAX ``fcont``, pencil_tpu/physics/
forcing.py:62-128, reference forcing_cont, src/forcing.f90): a fixed
profile f(x) of amplitude ``ampl_ff`` and wavenumber ``k1_ff`` added to
du/dt inside the RHS, in the Forcing module's place of the module order
(after Magnetic's J×B/ρ): 'ABC' (Arnold-Beltrami-Childress; Galloway &
Frisch 1986), 'RobertsFlow' (Roberts 1972), 'cosx*cosy*cosz' and 'xz' (a
parabolic envelope over ``fcont_box``); '' and 'nothing' are inert.  The
profile does not depend on time (JAX's RHS calls it at t = 0), so the
kernels read it as a field built once a model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar, Optional

import numpy as np
import torch

from .base import ModuleBase, accumulate

# the continuous-forcing profiles (JAX forcing.py:72-122): each name and
# its alias; '' and 'nothing' are the inert ones
FCONT_PROFILES = ("", "nothing", "xz", "cosx*cosy*cosz", "ABC", "abc",
                  "RobertsFlow", "Roberts")


def shell_vectors(kf: float, dk: float) -> np.ndarray:
    """Integer wavevectors with |k| ∈ [kf−dk, kf+dk] (excluding k=0)."""
    kmax = int(np.ceil(kf + dk))
    rng = np.arange(-kmax, kmax + 1)
    kx, ky, kz = np.meshgrid(rng, rng, rng, indexing="ij")
    kk = np.stack([kx.ravel(), ky.ravel(), kz.ravel()], axis=1).astype(np.float64)
    kabs = np.sqrt((kk ** 2).sum(1))
    sel = (kabs > 0) & (np.abs(kabs - kf) <= dk)
    out = kk[sel]
    if len(out) == 0:
        raise ValueError(f"empty forcing shell kf={kf} dk={dk}")
    return out


@dataclass(frozen=True)
class ForcingTables:
    """Per-model constants on the device, built once so that a step never
    copies from the host."""

    shell: torch.Tensor      # (nk, 3) integer wavevectors
    box: torch.Tensor        # (3,) 2π/L per axis
    norm: torch.Tensor       # 0-d 1/√(1+σ²)
    zero: torch.Tensor       # (1,) padding of the kick vector
    # replay mode: the (nt, 5) rows (kx, ky, kz, phase, φ), √(1+σ²), the
    # unit vectors x̂ and ŷ, and the grid and Shear of the kx shift
    seq: Optional[torch.Tensor] = None
    hel: Optional[torch.Tensor] = None
    ex: Optional[torch.Tensor] = None
    ey: Optional[torch.Tensor] = None
    spec: object = None
    shear: object = None


@dataclass(frozen=True)
class Forcing(ModuleBase):
    name: ClassVar[str] = "forcing"

    force: float = 0.02
    kf: float = 3.0      # forcing-shell radius in box-wavenumber units
    dk: float = 0.5
    relhel: float = 1.0  # σ: 1 = maximally helical, 0 = non-helical
    # replay mode: the reference's per-step draws ((kx, ky, kz, phase, φ),
    # ...), the shell's mean |k| from k.dat, slope_ff and cs0eff as in
    # fconst_coefs_hel; lscale_kvector_tobox scales k.dat's integer
    # wavevectors by 2π/L per axis (kav stays unscaled, as there)
    sequence: tuple = None
    kav: float = 0.0
    slope_ff: float = 0.0
    cs0eff: float = 1.0
    lscale_kvector_tobox: bool = False
    # continuous forcing, a term of the RHS (JAX forcing.py:62-70)
    lforcing_cont: bool = False
    iforcing_cont: str = ""
    ampl_ff: float = 0.0
    k1_ff: float = 1.0
    omega_fcont: float = 0.0
    # box corners (x0, x1, z0, z1) of the 'xz' envelope
    fcont_box: tuple = (0.0, 1.0, 0.0, 1.0)

    def fcont(self, grid):
        """The continuous-forcing profile (3, nx, ny, nz) on ``grid``'s
        interior coordinates, in JAX's operation order
        (pencil_tpu/physics/forcing.py:72-122); raises for a profile that
        is not ported."""
        k = self.k1_ff
        x, y, z = grid.xg, grid.yg, grid.zg
        prof = self.iforcing_cont
        zero = torch.zeros_like(x + y + z)
        if prof in ("", "nothing"):
            return torch.stack([zero, zero, zero])
        if prof == "xz":
            gs = self.fcont_box
            fy = (self.ampl_ff * (x - gs[0]) * (gs[1] - x)
                  * (z - gs[2]) * (gs[3] - z)) + zero
            return torch.stack([zero, fy, zero])
        if prof == "cosx*cosy*cosz":
            fact = -self.ampl_ff
            return torch.stack([
                fact * torch.sin(k * x) * torch.cos(k * y) * torch.cos(k * z),
                fact * torch.cos(k * x) * torch.sin(k * y) * torch.cos(k * z),
                fact * torch.cos(k * x) * torch.cos(k * y) * torch.sin(k * z),
            ])
        if prof in ("ABC", "abc"):
            return self.ampl_ff * torch.stack([
                torch.sin(k * z) + torch.cos(k * y) + zero,
                torch.sin(k * x) + torch.cos(k * z) + zero,
                torch.sin(k * y) + torch.cos(k * x) + zero,
            ])
        if prof in ("RobertsFlow", "Roberts"):
            sqrt2 = 1.4142135623730951
            return self.ampl_ff * torch.stack([
                -torch.cos(k * x) * torch.sin(k * y) + zero,
                torch.sin(k * x) * torch.cos(k * y) + zero,
                sqrt2 * torch.cos(k * x) * torch.cos(k * y) + zero,
            ])
        raise NotImplementedError(
            f"pencil_tpu_torch: iforcing_cont={prof!r} (ported: "
            "cosx*cosy*cosz, ABC, RobertsFlow, xz)")

    def fcont_live(self) -> bool:
        """True where the continuous forcing adds a term (on, and not an
        inert profile)."""
        return self.lforcing_cont and self.iforcing_cont not in ("",
                                                                 "nothing")

    def rhs(self, pen, df, ts):
        if self.lforcing_cont:
            accumulate(df, "uu", self.fcont(pen.grid))

    def tables(self, spec, device, dtype=torch.float32,
               shear=None) -> ForcingTables:
        """The model's forcing constants on ``device``; ``shear`` (the
        Shear module or None) shifts a replayed kx into the shearing
        frame."""
        box = [2.0 * np.pi / L for L in (spec.Lx, spec.Ly, spec.Lz)]
        dev = dict(dtype=dtype, device=device)
        replay = {}
        if self.sequence is not None:
            replay = dict(
                seq=torch.tensor(self.sequence, **dev).reshape(-1, 5),
                hel=torch.sqrt(torch.tensor(1.0 + self.relhel * self.relhel,
                                            **dev)),
                ex=torch.tensor([1.0, 0.0, 0.0], **dev),
                ey=torch.tensor([0.0, 1.0, 0.0], **dev),
                spec=spec, shear=shear)
        return ForcingTables(
            shell=torch.as_tensor(shell_vectors(self.kf, self.dk), **dev),
            box=torch.tensor(box, **dev),
            norm=1.0 / torch.sqrt(torch.tensor(
                1.0 + self.relhel * self.relhel, **dev)),
            zero=torch.zeros(1, **dev), **replay)

    @staticmethod
    def draw(tables: ForcingTables, generator):
        """One step's draws: (shell index, phase in [−π, π), normal e(3))."""
        dev, dt = tables.box.device, tables.box.dtype
        idx = torch.randint(0, tables.shell.shape[0], (1,),
                            generator=generator, device=dev)
        phase = (torch.rand((), generator=generator, device=dev, dtype=dt)
                 * (2.0 * math.pi) - math.pi)
        e = torch.randn(3, generator=generator, device=dev, dtype=dt)
        return idx, phase, e

    def kick_coeffs(self, tables: ForcingTables, draws, dt, eos):
        """(k_phys(3), phase, f_re(3), f_im(3), N·dt) from one step's draws;
        duu = N·dt·Re[(f_re + i f_im)·e^{i(k·x+phase)}].  In replay mode
        ``draws`` is (it, t): the step's index and its end time."""
        if self.sequence is not None:
            return self._replay_coeffs(tables, draws, dt)
        idx, phase, e = draws
        kvec = torch.index_select(tables.shell, 0, idx.reshape(1))[0]
        e = e / torch.sqrt(torch.sum(e * e))
        # Gram-Schmidt: remove the component along k
        khat = kvec / torch.sqrt(torch.sum(kvec * kvec))
        e = e - torch.sum(e * khat) * khat
        e = e / torch.clamp_min(torch.sqrt(torch.sum(e * e)), 1e-12)
        kxe = torch.linalg.cross(kvec, e)
        kxe = kxe / torch.clamp_min(torch.sqrt(torch.sum(kxe * kxe)), 1e-12)
        kxkxe = torch.linalg.cross(khat, kxe)
        f_re = tables.norm * kxe                      # real part of f_k
        f_im = -tables.norm * self.relhel * kxkxe     # imag part (−iσ k̂×(k×e))
        k_phys = kvec * tables.box
        cs0 = eos.cs0 if eos is not None else 1.0
        kf_mag = torch.sqrt(torch.sum(k_phys * k_phys))
        N = self.force * cs0 * torch.sqrt(
            kf_mag * cs0 / torch.clamp_min(dt, 1e-30))
        return k_phys, phase, f_re, f_im, N * dt

    def _replay_coeffs(self, tables: ForcingTables, draws, dt):
        """The replay's (k, phase, coef1, coef2, fact) from the sequence's
        row ``it`` (JAX forcing.py:130-193: the shearing-frame kx shift at
        ``t``, e = x̂ unless k ∥ x̂, rotated by φ about k)."""
        it, t = draws
        seq = tables.seq
        row = torch.index_select(
            seq, 0, torch.clamp(it, 0, seq.shape[0] - 1).reshape(1).long())[0]
        kvec = row[:3]
        if self.lscale_kvector_tobox:
            kvec = kvec * tables.box
        phase, phi = row[3], row[4]
        kx, ky, kz = kvec[0], kvec[1], kvec[2]
        if tables.shear is not None and t is not None:
            # shearing-frame forcing: kx stays shear-periodic near kx0
            # (forcing.f90:1396-1407); Fortran mod keeps the dividend's sign
            gs = tables.spec
            deltay = tables.shear.deltay(t, gs.Lx, gs.Ly)
            pix = math.pi / gs.Lx
            arg = ky * deltay / gs.Lx - pix
            fmod = arg - torch.trunc(arg / (2.0 * pix)) * (2.0 * pix)
            kx = kx + fmod + pix
            kvec = torch.stack([kx, ky, kz])
        e = torch.where((ky == 0.0) & (kz == 0.0), tables.ey, tables.ex)
        e1 = torch.linalg.cross(kvec, e)
        e1 = e1 / torch.sqrt(torch.sum(e1 * e1))
        e2 = torch.linalg.cross(kvec, e1)
        e2 = e2 / torch.sqrt(torch.sum(e2 * e2))
        ee = torch.cos(phi) * e1 + torch.sin(phi) * e2
        k2 = torch.sum(kvec * kvec)
        k = torch.sqrt(k2)
        kde = torch.sum(kvec * ee)
        kxe = torch.linalg.cross(kvec, ee)
        kkxe = torch.linalg.cross(kvec, kxe)
        ffnorm = (tables.hel * k * torch.sqrt(k2 - kde * kde)
                  / float(np.sqrt(self.kav * self.cs0eff ** 3))
                  * (k / self.kav) ** self.slope_ff)
        fact = self.force / ffnorm * torch.sqrt(dt)
        return kvec, phase, k * kxe, self.relhel * kkxe, fact

    def kick_vector(self, tables: ForcingTables, draws, dt, eos):
        """The (12,) kick vector the last-substep kernel reads:
        [k_phys(3), phase, f_re(3), f_im(3), N·dt, 0] (JAX fused_rhs.py:600-606)."""
        k_phys, phase, f_re, f_im, ndt = self.kick_coeffs(tables, draws, dt, eos)
        return torch.cat([k_phys, phase.reshape(1), f_re, f_im,
                          ndt.reshape(1), tables.zero])

    def after_timestep(self, fields, grid, tables, draws, dt, eos):
        """The kick as a separate pass over u (the eager path)."""
        k_phys, phase, f_re, f_im, ndt = self.kick_coeffs(tables, draws, dt, eos)
        theta = (k_phys[0] * grid.xg + k_phys[1] * grid.yg
                 + k_phys[2] * grid.zg + phase)
        c, s = torch.cos(theta), torch.sin(theta)
        duu = ndt * torch.stack([f_re[i] * c - f_im[i] * s for i in range(3)])
        return {**fields, "uu": fields["uu"] + duu}
