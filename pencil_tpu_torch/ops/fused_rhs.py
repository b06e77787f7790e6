"""The fused RHS kernels and their plain versions (counterpart of
``pencil_tpu/ops/fused_rhs.py``).

Each wrapper dispatches on the device of the tensor it is given: a CUDA
tensor launches the hand-written kernel of ``csrc/``, or raises; a CPU
tensor runs the plain PyTorch version beside it.  There is no fallback
from a kernel to its plain version.

The flagship step (wrap mode, ``csrc/fused_rhs.cu``), on the raw periodic
stack (7, nx, ny, nz) of forced MHD, or (4, nx, ny, nz) of forced hydro
(the same source built with ``PC_MAG=0``, library ``fused_rhs_hydro``,
launch names with the suffix ``_hydro``: K1h, K2h, K3h, K3′h, K2Lh), or
with an entropy field (8, nx, ny, nz) and (5, nx, ny, nz) (built with
``PC_ENT=1``, libraries ``fused_rhs_ent`` and ``fused_rhs_hydro_ent``,
suffixes ``_ent`` and ``_hydro_ent``: K1e … K2Le and K1he … K2Lhe):

  rhs_first            K1   df = RHS(f), max of the CFL 1/dt
  rhs_tail_defer       K2   f1 = f0 + cprev·df1 rebuilt from raw f0 and
                            df1; df2 = α·df1 + RHS(f1), f2 = f1 + βΔt·df2
  rhs_tail_mid         K3′  df ← α·df_prev + RHS(f), written over df_prev;
                            f ← f + βΔt·df (the middle substeps of 2N-RK4)
  rhs_tail_last        K3   f3 = f2 + βΔt·(α·df2 + RHS(f2)), plus the
                            helical forcing kick on u when a kick vector is
                            given
  rhs_tail_defer_last  K2L  K2's rebuilt f1 with K3's update and kick (the
                            one tail substep of 2N-RK2)

``fake=True`` on K1, K2 and K3 is K8, the memory floor: the same loads and
stores with RHS(f) = f·1.0000001 and a CFL maximum of 0 (wrong physics by
design; the MHD layout only).  The wrappers pick the library from the
model's field layout (``flagship_library``).  Where a del6 coefficient
(ν₃ of 'hyper3-simplified', η₃, D₃) is on, each of the five launches the
library's H3 instance, which adds the hyper-diffusion of u, A and lnρ and
its CFL rate, counted under the launch name with the suffix ``_h3``
(``launch_suffix``).

Stratified convection (zghost mode), on the interior stack (5, nx, ny, nz)
and its z-halo slabs zlo and zhi (5, nx, ny, 3), cut by a z-only ghost
fill (``Model.z_slabs``; the split of JAX's ``_fetch_zg``): the flagship
template built with ``PC_MAG=0 PC_ENT=1 PC_ZG=1`` (library
``fused_rhs_zg``, its ``pc_rhs_first`` and ``pc_rhs_tail_mid``), which
adds gravity and the cooling and heating layers and reads its z halo
from the slabs; magnetoconvection on the 8 fields (uu, lnrho, ss, aa) and
slabs (8, nx, ny, 3) on the same template built with ``PC_ENT=1 PC_ZG=1``
(library ``fused_rhs_zg_mag``, launch names with the suffix ``_mag``: K6m,
K7m); with Ω either build launches its Coriolis instances, with
'chi-const' conduction beside K-const its CHI instances, and with a del6
coefficient (ν₃, η₃, D₃) its H3 instances, counted under the launch names
with the suffixes ``_chi`` and ``_h3``, in that order (``zg_kernels``):

  rhs_zg           K6  df = RHS(f), max of the CFL 1/dt
  rhs_zg_upd       K7  df ← α·df_prev + RHS(f), written over df_prev;
                       f ← f + βΔt·df, a fresh tensor

The stratified shearing box (either set with Shear) runs the same two
wrappers on the template built with ``PC_SHEAR=1`` too (libraries
``fused_rhs_zg_shear``, K6s and K7s, launch names with ``_shear``, and
``fused_rhs_zg_mag_shear``, K6ms and K7ms, ``*_mag_shear``), on the stack
ghosted in x and y with the shifted x faces (nc, nx+6, ny+6, nz) and the
z-halo slabs of that stack (nc, nx+6, ny+6, 3) (``Model.zg_input``).
The isothermal stratified layer (the flagship's or forced hydro's
modules under gravity, with or without Shear) runs them on the template
built with ``PC_ZG=1`` and without ``PC_ENT`` (libraries
``fused_rhs_zg_iso``, ``fused_rhs_zg_iso_mag``, ``fused_rhs_zg_iso_shear``
and ``fused_rhs_zg_iso_mag_shear``: K6i/K7i, K6mi/K7mi, K6si/K7si,
K6msi/K7msi, launch names with ``_iso``, ``_iso_mag``, ``_iso_shear``,
``_iso_mag_shear``), which read g_z(z) as a vector (``zg_profiles``) and
have no CHI instances.  Stratified convection and magnetoconvection with
the Shock module's slot run them on the template built with ``PC_SHOCK=1``
too (libraries ``fused_rhs_zg_shock``, K6k/K7k, launch names with
``_shock``, and ``fused_rhs_zg_mag_shock``, K6mk/K7mk, ``_mag_shock``),
on the interior stack of all slots (6 or 9, the slot last) and its z
slabs, the slot's among them; they add ν_sh and have CHI, UPW and SHK
instances, no H3.

The shocked periodic box (wrap_aux mode), on the raw periodic 8-slot state
(8, nx, ny, nz) (uu, lnrho, aa, shock) after the shock pre-pass: the
flagship template built with ``PC_SHOCK=1`` (library ``fused_rhs_shock``,
its ``pc_rhs_first`` and ``pc_rhs_tail_mid``):

  rhs_wrap_shock       K1s  df = RHS(f), max of the CFL 1/dt
  rhs_wrap_shock_upd   K5w  df ← α·df_prev + RHS(f), written over df_prev;
                            f ← f + βΔt·df, a fresh (7, nx, ny, nz)

The shearing box (zroll mode), on the stack of all 8 slots ghosted in x and
y by ``fill_ghosts`` with shear-periodic x faces, z unghosted and periodic
(8, nx+6, ny+6, nz): the same template built with ``PC_SHOCK=1
PC_SHEAR=1`` (library ``fused_rhs_shear``), which adds the Shear terms:

  rhs_zroll        K4  K1s's function with the Shear terms
  rhs_zroll_upd    K5  K5w's, f ← f_interior + βΔt·df

The same wrappers serve the other isothermal layouts of these chains, each
on a build of its own (``_AUX_BUILDS``, ``aux_library``), counted under the
launch names with its suffix: supersonic hydro turbulence (uu, lnrho,
shock; ``PC_MAG=0 PC_SHOCK=1``, ``fused_rhs_shock_hydro``: K1sh, K5wh,
``*_hydro``), the shear box without the shock slot (uu, lnrho, aa;
``PC_SHEAR=1``, ``fused_rhs_shear_ns``: K4n, K5n, ``*_ns``) and the hydro
shear box with and without it (``PC_MAG=0 PC_SHOCK=1 PC_SHEAR=1``,
``fused_rhs_shear_hydro``: K4h, K5h, ``*_hydro``; ``PC_MAG=0
PC_SHEAR=1``, ``fused_rhs_shear_hydro_ns``: K4hn, K5hn, ``*_hydro_ns``),
and the hydro layouts of both chains with an entropy field (``PC_MAG=0
PC_ENT=1``): non-isothermal supersonic turbulence (uu, lnrho, ss, shock;
``fused_rhs_shock_hydro_ent``: K1she, K5whe, ``*_hydro_ent``) and the
hydro shear box with ss, with and without the shock slot
(``fused_rhs_shear_hydro_ent``: K4he, K5he, ``*_hydro_ent``;
``fused_rhs_shear_hydro_ent_ns``: K4hne, K5hne, ``*_hydro_ent_ns``), and
the MHD layouts with an entropy field (``PC_ENT=1``): non-isothermal MHD
shock turbulence (uu, lnrho, ss, aa, shock; ``fused_rhs_shock_ent``:
K1se, K5wse, ``*_ent``) and the MHD shear box with ss, with and without
the shock slot (``fused_rhs_shear_ent``: K4e, K5e, ``*_ent``;
``fused_rhs_shear_ent_ns``: K4ne, K5ne, ``*_ent_ns``).

Every kernel but K8 adds gravity g_z(z) on u_z where the model has a
Gravity module, any of its z profiles, read from a device vector (nz,)
(``gravity_vector``) that each launch passes after the others; so each
module set of the periodic and aux chains may add Gravity (stratified
turbulence in a periodic box under 'sin-z'), and the z-ghosted ones may
leave it out (g_z = 0).  Every kernel but K8 also adds the continuous
forcing of Forcing(lforcing_cont=True) to du/dt last, read from a device
field (3, nx, ny, nz) (``fcont_tensor``) passed after g_z(z), and every
MHD kernel adds Magnetic's B_ext to B = ∇×A (a constant of
``kernel_params``), so u×B, J×B/ρ and the Alfvén speed read the imposed
field; with a null field the kernels skip the forcing, and a zero B_ext
adds -0.

Every build has UPW instances, picked where an lupw flag is on
(``upwind_flags``: lupw_lnrho, lupw_uu, lupw_ss), which upwind the
advection of those fields (Σ_a |u_a|·δ⁶_a f/(60Δ_a), JAX
``Pencils.ugrad(upwind=True)``), counted under the launch names with the
suffix ``_upw`` (after ``_chi``); no instance has both UPW and H3, and
``kernel_params`` refuses the pair.  The builds with the shock slot have
a SHK twin of each instance, picked where one of the shock diffusivities
D_sh, η_sh and χ_sh is on (``shock_coefficients``; 0 in a layout without
the slot), which adds them; it counts under its twin's launch name with
the suffix ``_sd`` (after ``_upw``).

The z-ghosted builds with ss take Entropy's other conduction and cooling
terms in every instance, without a flag of their own: 'K-profile''s K(z)
and dK/dz from a device vector (2, nz) (``kprof_vector``), passed after
the layer profiles and null where it is off; 'kramers' and 'chi-cspeed'
as chi-const's term with other parameters in the CHI instances
(``conduction_term``: an exponential factor, its clip and the weights of
the gradient product), picked as chi-const is.  The other builds refuse
them (``zg_entropy_options``).  Every build with ss takes Newtonian
cooling and the uniform heating and cooling as constants of
``kernel_params``: the z-ghosted builds in their RHS behind ``zgx``, the
periodic ones after a plane's stores with Viscosity's other flavours
(they set ``visx`` there).

Every H3 instance weights each field's del6 on its own: u's, lnρ's and
s's by ``PcParams.h6u``, ``h6l`` and ``h6s`` (Δ_a⁻⁶ of
'hyper3-simplified', ``diffrho_hyper3`` and ``chi_hyper3``, or
dline_1_a/60 of the mesh flavour, 'hyper3-mesh', ``diffrho_hyper3_mesh``
and ``chi_hyper3_mesh``, whose coefficients ν₃, D₃ and χ₃ are then
ν₃ᵐ·π⁻⁵, D₃ᵐ·π⁻⁵ and χ₃ᵐ·π⁻⁵, or of u's and s's anisotropic flavours
ν₃ⱼΔⱼ⁻⁶ and χ₃ⱼΔⱼ⁻⁶ with the coefficient 1), A's by Δ_a⁻⁶, and adds the
mesh flavours' constant rate ``hmesh`` to the advective CFL after the
wave-speed root (0 without them).  s's del6 (``chi3``, the builds with
ss) is added with no test, its coefficient 0 where it is off.  Under SAFI the shear builds' kernels take the x nodes of the
shear flow at 0 (``PcParams.x0``, ``dx``), so that they add no advection
by it and no |S x|/Δy: no new instance either.

``coef`` = [α, βΔt(, cprev)] and ``kick`` (12,) are device tensors, so no
launch needs a host copy of dt.  Outputs never go to a buffer another
block reads halos from; K7's df overwrites df_prev, which each point reads
only at itself (the JAX aliases {4: 0} and {2: 0}); so do K3′'s and
K5/K5w's.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.grid import inverse_spacings
from ..integrate.timestep import cfl_dt1, pow6
from ..parallel.halo import (ghosted_from_sheared_z_slabs,
                             ghosted_from_z_slabs)
from ..physics.base import TimestepAccum
from ..physics.pencils import Pencils
from ..physics.viscosity import PI5_1
from . import _build
from .stencil import BIDIAG, BIDIAG_TAPS, NGHOST, i, paired_weights

# Nothing here should reach cuDNN or a matmul, but a stencil written as a
# conv3d would silently drop to TF32 on Hopper and lose f32 parity.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# the suffix of each periodic library's launch names
_SUFFIX = {"fused_rhs": "", "fused_rhs_hydro": "_hydro",
           "fused_rhs_ent": "_ent", "fused_rhs_hydro_ent": "_hydro_ent"}
WRAP_LIBRARIES = tuple(_SUFFIX)
# the five kernels of each periodic library
_WRAP_KERNELS = ("rhs_first", "rhs_tail_defer", "rhs_tail_last",
                "rhs_tail_mid", "rhs_tail_defer_last")


# ---- plain PyTorch versions ---------------------------------------------
def rhs_plain(model, f, want_dt1=True, ghosted=False, wrap_z=False,
              grid=None):
    """(df, max 1/dt) of the composed module set on the periodic stack f,
    on the fully ghosted stack f when ``ghosted``, or on the x/y-ghosted
    stack f when ``wrap_z``.  The max is None when ``want_dt1`` is
    false.  ``grid`` replaces the model's grid (the zroll kernels' node
    coordinates)."""
    reg = model.reg
    pen = Pencils(f[: reg.ncom], grid or model.grid, reg, model.cfg,
                  model.eos, ghosted=ghosted, wrap_z=wrap_z)
    nghosted = 3 if ghosted else (2 if wrap_z else 0)
    shape = tuple(n - 2 * NGHOST if a < nghosted else n
                  for a, n in enumerate(f.shape[1:]))
    df = {}
    ts = TimestepAccum()
    for m in model.modules:
        m.rhs(pen, df, ts)
    parts = []
    for name, slot in reg.slots.items():
        if slot.kind != "pde":
            continue
        d = df.get(name)
        if d is None:
            d = torch.zeros((slot.ncomp,) + shape, dtype=f.dtype,
                            device=f.device)
        elif d.ndim == 3:
            d = d[None]
        parts.append(d)
    dfa = torch.cat(parts, dim=0)
    if not want_dt1:
        return dfa, None
    return dfa, cfl_dt1(ts, pen.grid, model.cfg.time).max()


FAKE_FACTOR = 1.0000001     # K8's stand-in RHS: f·(1 + 2⁻²³) in f32


def _tail_rhs(model, f, fake):
    """RHS(f) of a tail substep (no CFL), or K8's f·1.0000001."""
    if fake:
        return f[: model.reg.nvar] * FAKE_FACTOR
    return rhs_plain(model, f, want_dt1=False)[0]


def rhs_first_plain(model, fa, fake=False):
    """K1's plain version (K8's with ``fake``): (df, 0-d max of 1/dt)."""
    if fake:
        return _tail_rhs(model, fa, True), fa.new_zeros(())
    return rhs_plain(model, fa)


def rhs_tail_defer_plain(model, fa, df1, coef, fake=False):
    """K2's plain version (K8's with ``fake``): (df2, f2)."""
    alpha, bdt, cprev = coef[0], coef[1], coef[2]
    f1 = fa + cprev * df1
    dfn = alpha * df1 + _tail_rhs(model, f1, fake)
    return dfn, f1 + bdt * dfn


def rhs_tail_mid_plain(model, fa, df_prev, coef):
    """K3′'s plain version: (df, f); df is written over df_prev."""
    alpha, bdt = coef[0], coef[1]
    df_prev.copy_(alpha * df_prev + _tail_rhs(model, fa, False))
    return df_prev, fa + bdt * df_prev


def rhs_tail_last_plain(model, fa, df2, coef, kick=None, fake=False):
    """K3's plain version (K8's with ``fake``): f3, kicked when ``kick`` is
    given."""
    alpha, bdt = coef[0], coef[1]
    f3 = fa + bdt * (alpha * df2 + _tail_rhs(model, fa, fake))
    return f3 if kick is None else _kicked(model, f3, kick)


def rhs_tail_defer_last_plain(model, fa, df1, coef, kick=None):
    """K2L's plain version: f, kicked when ``kick`` is given."""
    alpha, bdt, cprev = coef[0], coef[1], coef[2]
    f1 = fa + cprev * df1
    f = f1 + bdt * (alpha * df1 + _tail_rhs(model, f1, False))
    return f if kick is None else _kicked(model, f, kick)


def _kicked(model, fa, kick):
    """fa with the helical forcing kick on u, in the angle-addition form
    of the kernels: θ = k·x + φ = A + B + C."""
    gs, grid = model.cfg.grid, model.grid
    x0, y0 = _node0(gs)
    ar = {n: torch.arange(n, dtype=fa.dtype, device=fa.device)
          for n in (gs.nx, gs.ny)}
    A = kick[0] * (x0 + gs.dx * ar[gs.nx])[:, None, None] + kick[3]
    B = kick[1] * (y0 + gs.dy * ar[gs.ny])[None, :, None]
    C = kick[2] * grid.zg
    cA, sA = torch.cos(A), torch.sin(A)
    cB, sB = torch.cos(B), torch.sin(B)
    cC, sC = torch.cos(C), torch.sin(C)
    P = cA * cB - sA * sB                      # cos(A+B)
    Q = sA * cB + cA * sB                      # sin(A+B)
    iuu = model.reg.slice("uu").start
    kicked = []
    for c in range(3):
        a, b = kick[4 + c], kick[7 + c]
        U = a * cC - b * sC
        V = a * sC + b * cC
        kicked.append(fa[iuu + c] + kick[10] * (P * U - Q * V))
    return torch.cat([fa[:iuu], torch.stack(kicked), fa[iuu + 3:]])


def rhs_zg_plain(model, fa, zlo, zhi):
    """K6's (K6m's, K6i's, K6mi's, K6k's, K6mk's) plain version: (df, 0-d
    max of 1/dt) on the interior stack and its z-halo slabs, the shock
    slot among them where the layout has it."""
    return rhs_plain(model, ghosted_from_z_slabs(fa, zlo, zhi), ghosted=True)


def rhs_zg_upd_plain(model, fa, zlo, zhi, df_prev, coef):
    """K7's (K7m's, K7i's, K7mi's, K7k's, K7mk's) plain version: (df, f)
    of the evolved fields; df is written over df_prev."""
    alpha, bdt = coef[0], coef[1]
    dfa, _ = rhs_plain(model, ghosted_from_z_slabs(fa, zlo, zhi),
                       want_dt1=False, ghosted=True)
    df_prev.copy_(alpha * df_prev + dfa)
    return df_prev, fa[: model.reg.nvar] + bdt * df_prev


def rhs_zg_shear_plain(model, fg, zlo, zhi):
    """K6s's (K6ms's, K6si's, K6msi's) plain version: (df, 0-d max of
    1/dt) on the x/y-ghosted stack with the shifted x faces and its z-halo
    slabs, x at the kernels' nodes."""
    return rhs_plain(model, ghosted_from_sheared_z_slabs(fg, zlo, zhi),
                     ghosted=True, grid=node_grid(model))


def rhs_zg_shear_upd_plain(model, fg, zlo, zhi, df_prev, coef):
    """K7s's (K7ms's, K7si's, K7msi's) plain version: (df, f); df is
    written over df_prev."""
    alpha, bdt = coef[0], coef[1]
    dfa, _ = rhs_plain(model, ghosted_from_sheared_z_slabs(fg, zlo, zhi),
                       want_dt1=False, ghosted=True, grid=node_grid(model))
    df_prev.copy_(alpha * df_prev + dfa)
    return df_prev, i(fg[: model.reg.nvar], (0, 1)) + bdt * df_prev


def zg_plain(model):
    """The plain versions (first, update) of ``model``'s z-ghosted
    kernels: K6/K7's, or in the x/y-ghosted layout (``Model.zg_xy``: Shear,
    or the z BCs 'pot'/'div', which run the shear build at S = 0)
    K6s/K7s's."""
    if not model.zg_xy:
        return rhs_zg_plain, rhs_zg_upd_plain
    return rhs_zg_shear_plain, rhs_zg_shear_upd_plain


def _node0(gs):
    """First node of each periodic axis: x0 + ½dx."""
    return gs.x0 + 0.5 * gs.dx, gs.y0 + 0.5 * gs.dy


def node_grid(model):
    """The model's grid with x at the zroll kernels' nodes x0 + ½dx + i·dx
    in f32 (the JAX tile rule, fused_rhs.py:99-102, :151); built once per
    model."""
    g = model.__dict__.get("_node_grid")
    if g is None:
        gs = model.cfg.grid
        x0, _ = _node0(gs)
        i = torch.arange(gs.nx, dtype=model.dtype, device=model.device)
        g = dataclasses.replace(model.grid, x=x0 + gs.dx * i)
        model.__dict__["_node_grid"] = g
    return g


def rhs_zroll_plain(model, fg):
    """K4's plain version: (df, 0-d max of 1/dt) on the x/y-ghosted
    stack."""
    return rhs_plain(model, fg, wrap_z=True, grid=node_grid(model))


def rhs_zroll_upd_plain(model, fg, df_prev, coef):
    """K5's plain version: (df, f); df is written over df_prev."""
    alpha, bdt = coef[0], coef[1]
    dfa, _ = rhs_plain(model, fg, want_dt1=False, wrap_z=True,
                       grid=node_grid(model))
    df_prev.copy_(alpha * df_prev + dfa)
    return df_prev, i(fg[: model.reg.nvar], (0, 1)) + bdt * df_prev


def rhs_wrap_shock_plain(model, fa):
    """K1s's plain version: (df, 0-d max of 1/dt) on the periodic 8-slot
    state."""
    return rhs_plain(model, fa)


def rhs_wrap_shock_upd_plain(model, fa, df_prev, coef):
    """K5w's plain version: (df, f); df is written over df_prev."""
    alpha, bdt = coef[0], coef[1]
    df_prev.copy_(alpha * df_prev + _tail_rhs(model, fa, False))
    return df_prev, fa[: model.reg.nvar] + bdt * df_prev


# ---- the kernels --------------------------------------------------------
class PcParams(ctypes.Structure):
    """Mirror of ``struct PcParams`` in csrc/fused_rhs.cu."""

    _fields_ = [
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("isothermal", ctypes.c_int),
        ("w1", ctypes.c_float * 3), ("w2", ctypes.c_float * 3),
        ("wm", ctypes.c_float * 12),
        ("inv", ctypes.c_float * 3), ("invsq", ctypes.c_float * 3),
        ("nu", ctypes.c_float), ("eta", ctypes.c_float),
        ("cs20", ctypes.c_float), ("gm1", ctypes.c_float),
        ("lnrho0", ctypes.c_float),
        ("dxyz2", ctypes.c_float), ("cdt", ctypes.c_float),
        ("dif", ctypes.c_float),
        ("x0", ctypes.c_float), ("y0", ctypes.c_float),
        ("dx", ctypes.c_float), ("dy", ctypes.c_float),
        ("om", ctypes.c_float * 3),
        ("g_cp", ctypes.c_float), ("cp", ctypes.c_float),
        ("gamma", ctypes.c_float), ("lnTT0", ctypes.c_float),
        ("cpchi", ctypes.c_float), ("hcond0", ctypes.c_float),
        ("two_nu", ctypes.c_float), ("eta_heat", ctypes.c_float),
        ("maxdif", ctypes.c_float), ("cdtv", ctypes.c_float),
        ("nu_shock", ctypes.c_float), ("nu3", ctypes.c_float),
        ("eta3", ctypes.c_float), ("diff3", ctypes.c_float),
        ("dif3", ctypes.c_float),
        ("w6", ctypes.c_float * 3), ("inv6", ctypes.c_float * 3),
        ("S", ctypes.c_float), ("cool", ctypes.c_float),
        ("cs2c", ctypes.c_float), ("heat_norm", ctypes.c_float),
        ("bext", ctypes.c_float * 3),
        ("diffrho_shock", ctypes.c_float), ("eta_shock", ctypes.c_float),
        ("chi_shock", ctypes.c_float), ("gchi_shock", ctypes.c_float),
        ("upw_inv", ctypes.c_float * 3), ("upw", ctypes.c_int * 3),
        ("h6u", ctypes.c_float * 3), ("h6l", ctypes.c_float * 3),
        ("hmesh", ctypes.c_float),
        ("kq_rho", ctypes.c_float), ("kq_T", ctypes.c_float),
        ("kp_rho", ctypes.c_float), ("kp_T", ctypes.c_float),
        ("kmin", ctypes.c_float), ("kmax", ctypes.c_float),
        ("kexp", ctypes.c_int),
        ("tau_cool", ctypes.c_float), ("ttref", ctypes.c_float),
        ("cp_g", ctypes.c_float), ("heat_uniform", ctypes.c_float),
        ("cool_uniform", ctypes.c_float),
        ("visx", ctypes.c_int),
        ("nu_s", ctypes.c_float), ("nu_r", ctypes.c_float),
        ("zeta", ctypes.c_float), ("diffrho", ctypes.c_float),
        ("nu_ss", ctypes.c_float), ("nu_t", ctypes.c_float),
        ("nu_c", ctypes.c_float), ("nua", ctypes.c_float * 3),
        ("chi3", ctypes.c_float), ("h6s", ctypes.c_float * 3),
    ]


# the flagship template's field layouts (registry order), each with the
# library built for it: forced MHD, forced hydro (PC_MAG=0), and the two
# with an entropy field between lnrho and aa (PC_ENT=1)
_LAYOUTS = {
    "fused_rhs": {"uu": slice(0, 3), "lnrho": slice(3, 4),
                  "aa": slice(4, 7)},
    "fused_rhs_hydro": {"uu": slice(0, 3), "lnrho": slice(3, 4)},
    "fused_rhs_ent": {"uu": slice(0, 3), "lnrho": slice(3, 4),
                      "ss": slice(4, 5), "aa": slice(5, 8)},
    "fused_rhs_hydro_ent": {"uu": slice(0, 3), "lnrho": slice(3, 4),
                            "ss": slice(4, 5)},
}
# the modules whose terms the template implements (forcing rides along as
# the kick, gravity as its g_z(z) vector); a layout with any other module
# (shear, shock) is not the template's
_TEMPLATE_MODULES = frozenset(("eos", "density", "hydro", "viscosity",
                               "magnetic", "entropy", "gravity", "forcing"))


def flagship_library(model) -> str:
    """The library of the flagship template whose field layout is
    ``model``'s: 'fused_rhs' (uu, lnrho, aa), 'fused_rhs_hydro' (uu,
    lnrho), 'fused_rhs_ent' (uu, lnrho, ss, aa) or 'fused_rhs_hydro_ent'
    (uu, lnrho, ss), each with its H3 instances for del6 hyper-diffusion;
    raises for any other layout, and for a module or an entropy layer
    profile that the template has no terms for."""
    reg, cfg = model.reg, model.cfg
    ent = cfg.module("entropy")
    if {m.name for m in cfg.modules} <= _TEMPLATE_MODULES and (
            ent is None or (ent.cool == 0.0 and ent.luminosity == 0.0)):
        for lib, layout in _LAYOUTS.items():
            n = sum(sl.stop - sl.start for sl in layout.values())
            if reg.nvar == reg.ncom == n and set(reg.slots) == set(layout) \
                    and all(reg.slice(k) == v for k, v in layout.items()):
                return lib
    raise NotImplementedError(
        "fused kernels: the flagship's (uu, lnrho, aa) or the hydro "
        "(uu, lnrho) field layout, each with or without ss, and their "
        f"modules only, got {reg.comp_names} of "
        f"{sorted(m.name for m in cfg.modules)}")


# The shock and shear builds of the template (the aux chains), each with
# its field layout (an aux slot last, which the kernels read and never
# write), its module set (forcing rides along as the kick after the step,
# gravity as its g_z(z) vector: both optional),
# the base of its launch names (first, update) and their suffix: the
# shocked periodic box, MHD or hydro (wrap_aux), and the shear box, MHD or
# hydro, each with or without the shock slot (zroll); each also with an
# entropy field.
_ISO = frozenset(("eos", "density", "hydro", "viscosity"))
_MHD, _HYD = _LAYOUTS["fused_rhs"], _LAYOUTS["fused_rhs_hydro"]
_HENT, _ENT = _LAYOUTS["fused_rhs_hydro_ent"], _LAYOUTS["fused_rhs_ent"]
_WRAP_AUX = ("rhs_wrap_shock", "rhs_wrap_shock_upd")
_ZROLL = ("rhs_zroll", "rhs_zroll_upd")
_AUX_BUILDS = {
    "fused_rhs_shock": (dict(_MHD, shock=slice(7, 8)),
                        _ISO | {"magnetic", "shock"}, _WRAP_AUX, ""),
    "fused_rhs_shock_hydro": (dict(_HYD, shock=slice(4, 5)),
                              _ISO | {"shock"}, _WRAP_AUX, "_hydro"),
    "fused_rhs_shear": (dict(_MHD, shock=slice(7, 8)),
                        _ISO | {"magnetic", "shock", "shear"}, _ZROLL, ""),
    "fused_rhs_shear_ns": (_MHD, _ISO | {"magnetic", "shear"}, _ZROLL,
                           "_ns"),
    "fused_rhs_shear_hydro": (dict(_HYD, shock=slice(4, 5)),
                              _ISO | {"shock", "shear"}, _ZROLL, "_hydro"),
    "fused_rhs_shear_hydro_ns": (_HYD, _ISO | {"shear"}, _ZROLL,
                                 "_hydro_ns"),
    "fused_rhs_shock_hydro_ent": (dict(_HENT, shock=slice(5, 6)),
                                  _ISO | {"entropy", "shock"}, _WRAP_AUX,
                                  "_hydro_ent"),
    "fused_rhs_shear_hydro_ent": (dict(_HENT, shock=slice(5, 6)),
                                  _ISO | {"entropy", "shock", "shear"},
                                  _ZROLL, "_hydro_ent"),
    "fused_rhs_shear_hydro_ent_ns": (_HENT, _ISO | {"entropy", "shear"},
                                     _ZROLL, "_hydro_ent_ns"),
    "fused_rhs_shock_ent": (dict(_ENT, shock=slice(8, 9)),
                            _ISO | {"magnetic", "entropy", "shock"},
                            _WRAP_AUX, "_ent"),
    "fused_rhs_shear_ent": (dict(_ENT, shock=slice(8, 9)),
                            _ISO | {"magnetic", "entropy", "shock", "shear"},
                            _ZROLL, "_ent"),
    "fused_rhs_shear_ent_ns": (_ENT, _ISO | {"magnetic", "entropy", "shear"},
                               _ZROLL, "_ent_ns"),
}
# each aux build's launch names: its first and its update kernel
AUX_KERNELS = {lib: tuple(k + sfx for k in base)
               for lib, (_, _, base, sfx) in _AUX_BUILDS.items()}


def _sd_flags(lib):
    """The launch-name suffixes of an aux or z-ghosted build's instances
    without and with the shock diffusivities: ('', '_sd') with the shock
    slot, else ('',)."""
    layout = (_AUX_BUILDS.get(lib) or _ZG_BUILDS[lib])[0]
    return ("", "_sd")[:1 + ("shock" in layout)]


# the z-ghosted builds, each with its field layout, its module set (the
# conv-slab's, with Magnetic, and each with Shear or with the Shock
# module's slot last; the isothermal stratified layer's, hydro or MHD,
# each with Shear; forcing rides along as the kick after the step) and its
# two launch names
_CONVSLAB = frozenset(("eos", "density", "hydro", "gravity", "viscosity",
                       "entropy"))
_STRAT = _ISO | {"gravity"}
_ZG_BUILDS = {
    "fused_rhs_zg": (_HENT, _CONVSLAB, ("rhs_zg", "rhs_zg_upd")),
    "fused_rhs_zg_mag": (_ENT, _CONVSLAB | {"magnetic"},
                         ("rhs_zg_mag", "rhs_zg_upd_mag")),
    "fused_rhs_zg_shear": (_HENT, _CONVSLAB | {"shear"},
                           ("rhs_zg_shear", "rhs_zg_upd_shear")),
    "fused_rhs_zg_mag_shear": (_ENT, _CONVSLAB | {"magnetic", "shear"},
                               ("rhs_zg_mag_shear", "rhs_zg_upd_mag_shear")),
    "fused_rhs_zg_iso": (_HYD, _STRAT, ("rhs_zg_iso", "rhs_zg_upd_iso")),
    "fused_rhs_zg_iso_mag": (_MHD, _STRAT | {"magnetic"},
                             ("rhs_zg_iso_mag", "rhs_zg_upd_iso_mag")),
    "fused_rhs_zg_iso_shear": (_HYD, _STRAT | {"shear"},
                               ("rhs_zg_iso_shear", "rhs_zg_upd_iso_shear")),
    "fused_rhs_zg_iso_mag_shear": (_MHD, _STRAT | {"magnetic", "shear"},
                                   ("rhs_zg_iso_mag_shear",
                                    "rhs_zg_upd_iso_mag_shear")),
    "fused_rhs_zg_shock": (dict(_HENT, shock=slice(5, 6)),
                           _CONVSLAB | {"shock"},
                           ("rhs_zg_shock", "rhs_zg_upd_shock")),
    "fused_rhs_zg_mag_shock": (dict(_ENT, shock=slice(8, 9)),
                               _CONVSLAB | {"magnetic", "shock"},
                               ("rhs_zg_mag_shock", "rhs_zg_upd_mag_shock")),
}
ZG_KERNELS = {lib: names for lib, (_, _, names) in _ZG_BUILDS.items()}
# the z-ghosted builds with ss, the only ones with CHI instances
ZG_CHI_LIBRARIES = tuple(lib for lib, (layout, _, _) in _ZG_BUILDS.items()
                         if "ss" in layout)
# the z-ghosted builds with the shock slot: SHK instances (the shock
# diffusivities), no H3 ones (del6 beside the slot is refused)
ZG_SHOCK_LIBRARIES = tuple(lib for lib, (layout, _, _) in _ZG_BUILDS.items()
                           if "shock" in layout)


def _zg_flags(lib):
    """The launch-name flags (after _chi) of a z-ghosted build's
    instances: ('', '_h3', '_upw'), without '_h3' in the builds with the
    shock slot."""
    return ("", "_upw") if lib in ZG_SHOCK_LIBRARIES else ("", "_h3", "_upw")


# Launches of each kernel: a wrapper adds one where it launches, and
# nowhere else, so a run can show that its main path went through them.
# The H3 instances of the periodic builds (suffix _h3) and the CHI and H3
# instances of the z-ghosted builds (_chi, _h3, _chi_h3; the builds
# without ss have no CHI, those with the shock slot no H3) count under
# names of their own; the aux builds' H3 instances under their builds'
# names.  The UPW instances of every build count under names of their own,
# with the suffix _upw (after _chi), and the SHK instances of the builds
# with the shock slot under theirs, with the suffix _sd (after _upw).
LAUNCHES = dict.fromkeys(
    [k + sfx + flag for flag in ("", "_h3", "_upw")
     for sfx in _SUFFIX.values() for k in _WRAP_KERNELS]
    + ["rhs_first_fake", "rhs_tail_defer_fake", "rhs_tail_last_fake"]
    + [k + chi + flag + sd for lib, names in ZG_KERNELS.items()
       for chi in ("", "_chi") for flag in _zg_flags(lib)
       for sd in _sd_flags(lib) for k in names
       if not chi or lib in ZG_CHI_LIBRARIES]
    + [k + upw + sd for lib, names in AUX_KERNELS.items() for k in names
       for upw in ("", "_upw") for sd in _sd_flags(lib)], 0)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def aux_library(model) -> str:
    """The shock or shear build of the flagship template whose layout and
    module set are ``model``'s (``_AUX_BUILDS``); raises for any other,
    and for an entropy layer profile, which only the z-ghosted builds
    have terms for."""
    lib = model.__dict__.get("_aux_library")
    if lib is not None:
        return lib
    reg = model.reg
    names = {m.name for m in model.cfg.modules} - {"forcing", "gravity"}
    ent = model.cfg.module("entropy")
    if ent is not None and (ent.cool != 0.0 or ent.luminosity != 0.0):
        raise NotImplementedError(
            "shock and shear kernels: no terms for the entropy layer "
            "profiles (Entropy.cool/luminosity), which only the z-ghosted "
            "builds of the conv-slab layout have")
    for lib, (layout, modules, _, _) in _AUX_BUILDS.items():
        n = max(sl.stop for sl in layout.values())
        if names == modules and reg.nf == n and set(reg.slots) == set(
                layout) and all(reg.slice(k) == v for k, v in layout.items()):
            model.__dict__["_aux_library"] = lib
            return lib
    raise NotImplementedError(
        "shock and shear kernels: the (uu, lnrho[, ss][, aa][, shock]) "
        "layouts of the shear and shocked boxes and their modules only, "
        f"got {reg.comp_names} of {sorted(names)}")


def upwind_flags(cfg):
    """(lupw_lnrho, lupw_uu, lupw_ss) of ``cfg``, False for each whose
    module is absent."""
    den, hyd, ent = (cfg.module(n) for n in ("density", "hydro", "entropy"))
    return (bool(den is not None and den.lupw_lnrho),
            bool(hyd is not None and hyd.lupw_uu),
            bool(ent is not None and ent.lupw_ss))


def shock_coefficients(cfg, reg):
    """(D_sh, η_sh, χ_sh) of ``cfg``: the shock diffusivities of lnρ, A
    and s, each 0 where it is off or the layout has no shock slot (JAX's
    modules then skip the term)."""
    if "shock" not in reg.slots:
        return 0.0, 0.0, 0.0
    den, mag, ent = (cfg.module(n) for n in ("density", "magnetic",
                                             "entropy"))
    return (max(den.diffrho_shock, 0.0) if den is not None else 0.0,
            max(mag.eta_shock, 0.0) if mag is not None else 0.0,
            ent.chi_shock if ent is not None
            and ent.shock_conduction(reg) else 0.0)


def aux_kernels(model):
    """The launch names (first, update) of ``model``'s aux build:
    AUX_KERNELS's, with the suffix _upw where its UPW instances run, then
    _sd where its SHK instances run."""
    return tuple(k + _upw_suffix(model) + _sd_suffix(model)
                 for k in AUX_KERNELS[aux_library(model)])


# the Viscosity flavours that no kernel instance takes, with why
CARD_REFUSED_VISCOSITY = {
    "hyper3-nu-const": "the JAX fused path raises on it (ROADMAP Queue 3), "
                       "and its 5th-difference lnrho term has no instance",
    "hyper3-rho-nu-const-symm": "its d5_i d_j cross terms are a 7x7 "
                                "stencil across the march",
}


def viscosity_refusals(cfg, zg_ss):
    """The Viscosity flavours of ``cfg`` that the kernels of its chain do
    not take, each named with why ([] when they take all): 'hyper3-nu-
    const' and 'hyper3-rho-nu-const-symm' on every chain, 'nu-cspeed'
    outside the z-ghosted builds with ss (``zg_ss``: the only ones with
    lnT formed beside the viscous force and registers to spare), and
    'hyper3_nu-const_aniso' beside another del6 flavour of u (one weight
    vector a field)."""
    visc = cfg.module("viscosity")
    if visc is None:
        return []
    t = visc.terms()
    out = [f"Viscosity {k!r} ({why})"
           for k, why in CARD_REFUSED_VISCOSITY.items() if t[k] > 0.0]
    if t["nu-cspeed"] > 0.0 and not zg_ss:
        out.append("Viscosity 'nu-cspeed' outside the z-ghosted builds "
                   "with ss (the periodic entropy builds hold 237-255 "
                   "registers; the others have no lnT)")
    if any(t["hyper3_nu-const_aniso"]) and (
            t["hyper3-simplified"] > 0.0 or t["hyper3-mesh"] > 0.0):
        out.append("Viscosity 'hyper3_nu-const_aniso' with another del6 "
                   "flavour of u (one weight vector a field)")
    return out


def aniso_rate(coeffs, inv):
    """The constant del6 rate Σ_j c_jΔⱼ⁻⁶/Σ_j Δⱼ⁻⁶ of an anisotropic del6
    with the coefficients ``coeffs`` ('hyper3_nu-const_aniso',
    ``chi_hyper3_aniso``), in f32 in the plain version's order; 0 where
    they are all 0."""
    if not any(coeffs):
        return np.float32(0.0)
    f32 = np.float32
    d16 = pow6(inv)
    num = f32(0.0)
    for a in range(3):
        num = num + f32(coeffs[a]) * d16[a]
    return num / ((d16[0] + d16[1]) + d16[2])


def chi_hyper3_coefficients(cfg):
    """(χ₃, χ₃ᵐ, (χ₃ₓ, χ₃ᵧ, χ₃_z)) of ``cfg``'s Entropy, 0 for each that is
    off: the del6 hyper-diffusion of s, its mesh flavour and its
    anisotropic flavour."""
    ent = cfg.module("entropy")
    if ent is None:
        return 0.0, 0.0, (0.0, 0.0, 0.0)
    return (max(ent.chi_hyper3, 0.0), max(ent.chi_hyper3_mesh, 0.0),
            tuple(float(c) for c in ent.chi_hyper3_aniso))


def hyper3_coefficients(cfg):
    """(ν₃, η₃, D₃) of ``cfg``, 0 for each that is off: the
    'hyper3-simplified' viscosity, the hyper-resistivity and the lnρ
    hyper-diffusion (the flavour whose rate is a diffusive one)."""
    visc, mag = cfg.module("viscosity"), cfg.module("magnetic")
    den = cfg.module("density")
    return (visc.coefficients()[2] if visc is not None else 0.0,
            max(mag.eta_hyper3, 0.0) if mag is not None else 0.0,
            max(den.diffrho_hyper3, 0.0) if den is not None else 0.0)


def hyper3_mesh_coefficients(cfg):
    """(ν₃ᵐ, D₃ᵐ) of ``cfg``, 0 for each that is off: the mesh flavours
    of the viscosity ('hyper3-mesh') and of the lnρ hyper-diffusion
    (``diffrho_hyper3_mesh``); the port's Magnetic has none, as JAX's."""
    visc, den = cfg.module("viscosity"), cfg.module("density")
    return (visc.mesh_coefficient() if visc is not None else 0.0,
            max(den.diffrho_hyper3_mesh, 0.0) if den is not None else 0.0)


def hyper3_terms(cfg):
    """Every del6 coefficient of ``cfg`` as (option name, coefficient), 0
    where it is off: ν₃ and ν₃ᵐ of u, η₃ of A, D₃ and D₃ᵐ of lnρ, the
    largest |ν₃ⱼ| of 'hyper3_nu-const_aniso', and χ₃, χ₃ᵐ and the largest
    |χ₃ⱼ| of s."""
    visc = cfg.module("viscosity")
    nua = (visc.terms()["hyper3_nu-const_aniso"] if visc is not None
           else (0.0,))
    chi3, chi3m, chia = chi_hyper3_coefficients(cfg)
    return tuple(zip(("nu_hyper3", "eta_hyper3", "diffrho_hyper3",
                      "nu_hyper3_mesh", "diffrho_hyper3_mesh",
                      "nu_aniso_hyper3", "chi_hyper3", "chi_hyper3_mesh",
                      "chi_hyper3_aniso"),
                     hyper3_coefficients(cfg)
                     + hyper3_mesh_coefficients(cfg)
                     + (max(abs(c) for c in nua), chi3, chi3m,
                        max(abs(c) for c in chia))))


def chi_hyper3_twice(cfg):
    """The flavours of Entropy's hyper-diffusion in use where more than
    one is, named ([] otherwise): the H3 instances have one weight vector
    and one coefficient for s."""
    chi3, chi3m, chia = chi_hyper3_coefficients(cfg)
    on = [name for name, c in (("chi_hyper3", chi3),
                               ("chi_hyper3_mesh", chi3m),
                               ("chi_hyper3_aniso", any(chia))) if c]
    return on if len(on) > 1 else []


def zg_library(model) -> str:
    """The z-ghosted build of the flagship template for ``model``:
    'fused_rhs_zg' (the conv-slab's uu, lnrho, ss) or 'fused_rhs_zg_mag'
    (with aa and Magnetic), or with Shear 'fused_rhs_zg_shear' and
    'fused_rhs_zg_mag_shear', each with or without forcing, Ω, chi-const
    conduction and del6 hyper-diffusion; without ss (the isothermal
    stratified layer: uu, lnrho and with Magnetic aa) 'fused_rhs_zg_iso',
    'fused_rhs_zg_iso_mag', and with Shear 'fused_rhs_zg_iso_shear' and
    'fused_rhs_zg_iso_mag_shear', each with or without forcing, Ω and
    del6; each with or without Gravity (without it g_z = 0: the kernels
    read a null vector); with the Shock module's slot after ss (or aa)
    'fused_rhs_zg_shock' and 'fused_rhs_zg_mag_shock', each with or
    without forcing, Ω, chi-const and the shock diffusivities; on a grid
    with z walls and x, y periodic; raises for another layout, module set
    or grid.  A set without Shear whose z BCs write ghost columns that no
    wrap gives ('pot', 'pwd', 'pfe', 'div': ``Model.zg_xy``) runs its
    Shear build, with S = 0, on the x/y-ghosted slabs.  Found once per
    model: the conv-slab step is bound by the host."""
    lib = model.__dict__.get("_zg_library")
    if lib is not None:
        return lib
    reg, cfg = model.reg, model.cfg
    names = {m.name for m in cfg.modules} - {"forcing", "gravity"}
    if model.zg_xy:
        names |= {"shear"}
    walls = tuple(cfg.grid.periodic) == (True, True, False)
    for lib, (layout, modules, _) in _ZG_BUILDS.items():
        n = max(sl.stop for sl in layout.values())
        if walls and names == modules - {"gravity"} and reg.nf == n \
                and reg.nvar == n - ("shock" in layout) and all(
                    reg.slice(k) == v for k, v in layout.items()):
            model.__dict__["_zg_library"] = lib
            return lib
    raise NotImplementedError(
        "zghost kernels: the conv-slab's (uu, lnrho, ss) layout and modules, "
        "with or without Magnetic's aa and with Shear or the Shock module's "
        "slot, or the same without ss and Entropy, with Shear, with z walls "
        "only, got "
        f"{reg.comp_names} of {sorted(names)}, periodic="
        f"{tuple(cfg.grid.periodic)}")


def zg_kernels(model):
    """The launch names (first, update) of ``model``'s z-ghosted build:
    ZG_KERNELS's, with the suffix _chi where its CHI instances run
    (chi-const on), then _h3 where its H3 instances run (a del6
    coefficient on) or _upw where its UPW instances run (an lupw flag
    on), then _sd where its SHK instances run (a shock diffusivity on,
    the builds with the shock slot); found once per model."""
    names = model.__dict__.get("_zg_kernels")
    if names is None:
        chi = "_chi" if kernel_params(model).cpchi > 0.0 else ""
        sfx = chi + _flag_suffix(model) + _sd_suffix(model)
        names = tuple(k + sfx for k in ZG_KERNELS[zg_library(model)])
        model.__dict__["_zg_kernels"] = names
    return names


def gravity_vector(model):
    """g_z(z) of ``model``'s Gravity on the interior z, a device vector
    (nz,) as the plain version computes it, which every kernel but K8
    reads; None without Gravity (the kernels then add -0).  Built once per
    model."""
    if "_gravity_vector" not in model.__dict__:
        grav = model.cfg.module("gravity")
        model.__dict__["_gravity_vector"] = (
            None if grav is None else grav.gz(model.grid.z).contiguous())
    return model.__dict__["_gravity_vector"]


def fcont_tensor(model):
    """The continuous forcing (3, nx, ny, nz) of ``model``'s Forcing on
    the interior grid, a device tensor as the plain version computes it
    (``Forcing.fcont``, float32), which every kernel but K8 adds to du/dt
    last; None where it is off or its profile inert (the kernels then
    skip it).  Built once per model."""
    if "_fcont" not in model.__dict__:
        forcing = model.cfg.module("forcing")
        model.__dict__["_fcont"] = (
            forcing.fcont(model.grid).contiguous()
            if forcing is not None and forcing.fcont_live() else None)
    return model.__dict__["_fcont"]


def zg_profiles(model):
    """The z profiles that ``model``'s z-ghosted build reads, as the plain
    version computes them, each a device vector (nz,) or None: (cooling
    profile, heating profile, g_z(z)), the layers' zeros where a layer is
    off; without ss (None, None, g_z(z)).  Built once per model."""
    p = model.__dict__.get("_zg_profiles")
    if p is None:
        z = model.grid.z
        ent = model.cfg.module("entropy")
        layers = (None, None) if ent is None else tuple(
            (torch.zeros_like(z) if v is None else v).contiguous()
            for v in ent.heat_cool_profiles(z, model.cfg.grid))
        p = layers + (gravity_vector(model),)
        model.__dict__["_zg_profiles"] = p
    return p


def kprof_vector(model):
    """K(z) and dK/dz(z) of 'K-profile' on the interior z, a device tensor
    (2, nz) as the plain version computes them (``Entropy.hcond_z``),
    which the z-ghosted builds with ss read; None where it is off (the
    kernels then skip the term).  Built once per model."""
    if "_kprof" not in model.__dict__:
        ent = model.cfg.module("entropy")
        model.__dict__["_kprof"] = (
            torch.stack(ent.hcond_z(model.grid)).contiguous()
            if ent is not None and ent.kprofile else None)
    return model.__dict__["_kprof"]


def _ptr(t):
    """A tensor's device pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def _terms(model):
    """The last inputs of every entry point but K8's: g_z(z) and the
    continuous forcing, each a device pointer or null."""
    return _ptr(gravity_vector(model)), _ptr(fcont_tensor(model))


def launch_suffix(model) -> str:
    """The suffix of the launch names of ``model``'s instances of the
    flagship template: its periodic library's ('', '_hydro', '_ent' or
    '_hydro_ent'), then '_h3' where it launches the H3 instances or
    '_upw' where it launches the UPW ones; or its aux build's ('',
    '_hydro', '_ns', '_hydro_ns', '_hydro_ent', '_hydro_ent_ns', '_ent',
    '_ent_ns'), whose H3 instances count under the same names, then
    '_upw' where it launches the UPW instances and '_sd' where it launches
    the SHK ones."""
    if model.mode in ("zroll", "wrap_aux"):
        return (_AUX_BUILDS[aux_library(model)][3] + _upw_suffix(model)
                + _sd_suffix(model))
    return _SUFFIX[flagship_library(model)] + _flag_suffix(model)


def _flag_suffix(model) -> str:
    """'_h3' where ``model``'s del6 coefficients are not all 0 in f32 (the
    kernels' own test, which picks the H3 instances), '_upw' where an
    lupw flag is on (the UPW instances; never both), else ''."""
    p = kernel_params(model)
    if p.nu3 > 0.0 or p.eta3 > 0.0 or p.diff3 > 0.0 or p.chi3 > 0.0:
        return "_h3"
    return _upw_suffix(model)


def _upw_suffix(model) -> str:
    """'_upw' where ``model`` launches the UPW instances, else ''."""
    return "_upw" if any(kernel_params(model).upw) else ""


def _sd_suffix(model) -> str:
    """'_sd' where ``model`` launches the SHK instances (a shock
    diffusivity on, which only a layout with the shock slot can have),
    else ''."""
    p = kernel_params(model)
    return ("_sd" if p.diffrho_shock > 0.0 or p.eta_shock > 0.0
            or p.chi_shock > 0.0 else "")


def kernel_params(model) -> PcParams:
    """The kernel constants of ``model``, rounded to f32 in the same order
    as the plain version computes them; built once per model."""
    p = model.__dict__.get("_pc_params")
    if p is not None:
        return p
    cfg, gs = model.cfg, model.cfg.grid
    if not all(gs.periodic):
        zg_library(model)
    elif "shock" in model.reg.slots or cfg.module("shear") is not None:
        aux_library(model)
    else:
        flagship_library(model)
    f32 = np.float32
    inv = np.array(inverse_spacings(gs), f32)
    invsq = inv * inv
    dxyz2 = (invsq[0] + invsq[1]) + invsq[2]
    visc = cfg.module("viscosity")
    vt = visc.terms()
    nu, nu_shock = vt["nu-const"], vt["nu-shock"]
    ent = cfg.module("entropy")
    bad = viscosity_refusals(cfg, not all(gs.periodic) and ent is not None)
    if bad:
        raise NotImplementedError(f"fused kernels: {bad}")
    den = cfg.module("density")
    diffrho = max(den.diffrho, 0.0)
    # Viscosity's other flavours and diffrho (visx): 'nu-simplified',
    # 'rho-nu-const', the bulk ζ, 'shock-simple', 'nu-cspeed', the
    # advective part of 'hyper3_nu-const_aniso' (whose del6 part is the
    # H3 instances' with ν₃ = 1 and the weights ν₃ⱼΔⱼ⁻⁶) and D; Entropy's
    # cooling joins them below
    nua = vt["hyper3_nu-const_aniso"]
    nu_s, nu_r = vt["nu-simplified"], vt["rho-nu-const"]
    zeta, nu_ss, nu_t = (vt["rho-nu-const-bulk"], vt["shock-simple"],
                         vt["nu-cspeed"])
    visx = any((nu_s, nu_r, zeta, nu_ss, nu_t, diffrho, *nua))
    mag = cfg.module("magnetic")
    eta = mag.eta if mag is not None else 0.0
    # the del6 hyper-diffusion (the H3 instances) and its constant CFL
    # rate max(ν₃, η₃, D₃)·dxyz₆/cdtv3 of the 'simplified' flavours; a
    # field with the mesh flavour has ν₃ᵐ·π⁻⁵ for its coefficient and
    # dline_1/60 for its weights in place of Δ⁻⁶, and their rates join
    # the advective CFL as one constant root (``mesh_rate``)
    # s's del6 (χ₃, the mesh χ₃ᵐ or the anisotropic χ₃ⱼ) the same way:
    # coefficient chi3 and weights h6s, its rate in dif3 or hmesh
    nu3, eta3, diff3 = hyper3_coefficients(cfg)
    nu3m, diff3m = hyper3_mesh_coefficients(cfg)
    chi3, chi3m, chia = chi_hyper3_coefficients(cfg)
    inv6 = pow6(inv)
    m3 = max(nu3, eta3, diff3, aniso_rate(nua, inv), chi3,
             aniso_rate(chia, inv))
    dxyz6 = (inv6[0] + inv6[1]) + inv6[2]
    dif3 = f32(m3) * dxyz6 / f32(cfg.time.cdtv3) if m3 > 0.0 else f32(0)
    if (nu3 > 0.0 and nu3m > 0.0) or (diff3 > 0.0 and diff3m > 0.0) \
            or chi_hyper3_twice(cfg):
        raise NotImplementedError(
            "fused kernels: two flavours of del6 on one field ('hyper3-"
            "simplified' with 'hyper3-mesh', diffrho_hyper3 with "
            "diffrho_hyper3_mesh, two of chi_hyper3, chi_hyper3_mesh and "
            "chi_hyper3_aniso): no instance has them")
    mesh6 = inv / f32(60.0)
    shear = cfg.module("shear")
    eos = model.eos
    chi = ent.chi if ent is not None and ent.chi_conduction else 0.0
    hcond0 = ent.hcond0 if ent is not None and ent.conduction else 0.0
    # the CHI instances' term: chi-const, or 'kramers' or 'chi-cspeed' as
    # its exponential form (kexp; the z-ghosted builds with ss); Newtonian
    # cooling and the uniform heating and cooling (every build with ss)
    if all(gs.periodic) and zg_entropy_options(ent):
        raise NotImplementedError(
            f"fused kernels: {zg_entropy_options(ent)} (the z-ghosted "
            "builds with ss only)")
    chiterm = conduction_term(ent, eos)
    # the constant diffusive rates; K-const's K·γ/(ρ·cp) joins per point,
    # and so do ν/ρ, ζ/ρ, ν_sh·shock and μ_T where visx is taken
    maxdiffus = max([v for v in (nu, nu_s, eta, chi * eos.gamma, diffrho)
                     if v > 0.0], default=0.0)
    dif = f32(maxdiffus) * dxyz2 / f32(cfg.time.cdtv) if maxdiffus else f32(0)
    heats = ent is not None
    hyd = cfg.module("hydro")
    upw = upwind_flags(cfg)
    hyper = max(c for _, c in hyper3_terms(cfg))
    if any(upw) and hyper > 0.0:
        raise NotImplementedError(
            "fused kernels: upwinding (lupw_lnrho, lupw_uu, lupw_ss) with "
            "del6 hyper-diffusion (nu_hyper3, eta_hyper3, diffrho_hyper3, "
            "chi_hyper3 or their other flavours): no instance has both")
    if hyper > 0.0 and "shock" in model.reg.slots \
            and not all(gs.periodic):
        raise NotImplementedError(
            "fused kernels: del6 hyper-diffusion (nu_hyper3, eta_hyper3, "
            "diffrho_hyper3, chi_hyper3 or their other flavours) with the "
            "Shock module's slot on a z-walled grid: no instance has both")
    diffrho_shock, eta_shock, chi_shock = shock_coefficients(cfg, model.reg)
    x0, y0 = _node0(gs)
    # the x nodes of the shear flow S·x in the shear builds: all 0 under
    # SAFI, which shifts the fields between substeps instead, so that the
    # flow's advection terms and CFL rate add 0 (the stretching terms keep
    # S)
    safi = shear is not None and shear.lshearadvection_as_shift
    wm = [sgn * c for c in BIDIAG for _, _, sgn in BIDIAG_TAPS]
    fl3 = ctypes.c_float * 3
    p = PcParams(
        nx=gs.nx, ny=gs.ny, nz=gs.nz, isothermal=int(eos.gamma == 1.0),
        w1=(ctypes.c_float * 3)(*paired_weights(1)),
        w2=(ctypes.c_float * 3)(*paired_weights(2)),
        wm=(ctypes.c_float * 12)(*wm),
        inv=(ctypes.c_float * 3)(*inv), invsq=(ctypes.c_float * 3)(*invsq),
        nu=max(nu, 0.0), eta=max(eta, 0.0),
        cs20=eos.cs20, gm1=eos.gamma - 1.0, lnrho0=eos.lnrho0,
        dxyz2=dxyz2, cdt=cfg.time.cdt, dif=dif,
        x0=0.0 if safi else x0, y0=y0, dx=0.0 if safi else gs.dx, dy=gs.dy,
        om=(ctypes.c_float * 3)(*(hyd.omega_vector() if hyd.Omega != 0.0
                                  else (0, 0, 0))),
        g_cp=eos.gamma / eos.cp, cp=eos.cp, gamma=eos.gamma,
        lnTT0=eos.lnTT0, cpchi=chiterm["cpchi"], hcond0=hcond0,
        two_nu=2.0 * max(nu, 0.0) if heats else 0.0,
        eta_heat=max(eta, 0.0) if heats and mag is not None
        and mag.lohmic_heat else 0.0,
        maxdif=maxdiffus, cdtv=cfg.time.cdtv,
        nu_shock=nu_shock,
        nu3=nu3m * PI5_1 if nu3m > 0.0 else 1.0 if any(nua) else nu3,
        eta3=eta3, diff3=diff3m * PI5_1 if diff3m > 0.0 else diff3,
        dif3=dif3,
        w6=fl3(*paired_weights(6)), inv6=fl3(*inv6),
        S=shear.S if shear is not None else 0.0,
        cool=ent.cool if heats else 0.0,
        cs2c=ent.cs2c(eos) if heats else 0.0,
        heat_norm=ent.heat_norm(gs) if heats else 0.0,
        # the imposed field, -0 where a component is 0: the add leaves B
        # bit for bit as the curl gives it
        bext=fl3(*(b if b != 0.0 else -0.0 for b in (
            mag.B_ext if mag is not None else (0.0, 0.0, 0.0)))),
        diffrho_shock=diffrho_shock, eta_shock=eta_shock,
        chi_shock=chi_shock, gchi_shock=eos.gamma * chi_shock,
        # 1/(60 Δ_a), the upwinding's scale, rounded in f32
        upw_inv=fl3(*(inv / f32(60.0))),
        upw=(ctypes.c_int * 3)(*upw),
        h6u=fl3(*(mesh6 if nu3m > 0.0
                  else np.array(nua, f32) * inv6 if any(nua) else inv6)),
        h6l=fl3(*(mesh6 if diff3m > 0.0 else inv6)),
        hmesh=mesh_rate(cfg, inv),
        kq_rho=chiterm["kq_rho"], kq_T=chiterm["kq_T"],
        kp_rho=chiterm["kp_rho"], kp_T=chiterm["kp_T"],
        kmin=chiterm["kmin"], kmax=chiterm["kmax"], kexp=chiterm["kexp"],
        tau_cool=ent.tau_cool if heats else 0.0,
        ttref=ent.TTref_cool if heats else 0.0,
        cp_g=eos.cp / eos.gamma if heats else 0.0,
        heat_uniform=ent.heat_uniform if heats else 0.0,
        cool_uniform=ent.cool_uniform if heats else 0.0,
        # a periodic build with ss forms the cooling after its stores
        visx=int(visx or (heats and all(gs.periodic) and any((
            ent.tau_cool, ent.heat_uniform, ent.cool_uniform)))),
        nu_s=nu_s, nu_r=nu_r, zeta=zeta, diffrho=diffrho,
        nu_ss=nu_ss, nu_t=nu_t, nu_c=visc.nu_cspeed if nu_t > 0.0 else 0.0,
        nua=fl3(*nua),
        chi3=(chi3m * PI5_1 if chi3m > 0.0 else 1.0 if any(chia)
              else chi3),
        h6s=fl3(*(mesh6 if chi3m > 0.0
                  else np.array(chia, f32) * inv6 if any(chia) else inv6)))
    model.__dict__["_pc_params"] = p
    return p


def zg_entropy_options(ent):
    """The options of ``ent`` that only the z-ghosted builds with ss
    implement (Entropy's other conduction terms), named; []
    for None.  Newtonian cooling and the uniform heating and cooling run
    on every build with ss."""
    if ent is None:
        return []
    return [name for name, on in (
        ("iheatcond 'K-profile'", ent.kprofile),
        ("iheatcond 'kramers'", ent.kramers),
        ("iheatcond 'chi-cspeed'", ent.cspeed_conduction)) if on]


def conduction_term(ent, eos):
    """The parameters of the CHI instances' conduction term A(∇²lnT +
    Σ_a (p_ρ∂_a lnρ + p_T∂_a lnT)∂_a lnT), A = c·exp(q_ρlnρ + q_T lnT)
    clipped to [A_min, A_max] where A_max > 0: chi-const's (c = cp·χ, q =
    0, p_ρ = p_T = 1; kexp 0: no exponential, its rate χγ constant),
    'kramers' (c = K₀, q_ρ = −(2n+1), q_T = 6.5n, p_ρ = −2n, p_T = 6.5n +
    1, the clip [χ_min, χ_max]·cp) or 'chi-cspeed' (c = cp·χ, q_T = c,
    p_ρ = 1, p_T = 1 + c); at most one of the three (the instance has
    one such term)."""
    out = dict(cpchi=0.0, kq_rho=0.0, kq_T=0.0, kp_rho=1.0, kp_T=1.0,
               kmin=0.0, kmax=0.0, kexp=0)
    if ent is None:
        return out
    terms = [k for k, on in (("chi-const", ent.chi_conduction),
                             ("kramers", ent.kramers),
                             ("chi-cspeed", ent.cspeed_conduction)) if on]
    if len(terms) > 1:
        raise NotImplementedError(
            f"fused kernels: iheatcond {terms} (one of chi-const, "
            "'kramers' and 'chi-cspeed' a CHI instance)")
    if ent.chi_conduction:
        out["cpchi"] = eos.cp * ent.chi
    elif ent.kramers:
        n = ent.nkramers
        out.update(cpchi=ent.hcond0_kramers, kq_rho=-(2.0 * n + 1.0),
                   kq_T=6.5 * n, kp_rho=-2.0 * n, kp_T=6.5 * n + 1.0,
                   kexp=1)
        if ent.chimax_kramers > 0.0:
            out.update(kmin=ent.chimin_kramers * eos.cp,
                       kmax=ent.chimax_kramers * eos.cp)
    elif ent.cspeed_conduction:
        out.update(cpchi=eos.cp * ent.chi, kq_T=ent.chi_cspeed,
                   kp_T=1.0 + ent.chi_cspeed, kexp=1)
    return out


def mesh_rate(cfg, inv):
    """The constant root √Σ (c·π⁻⁵·√Σ_a dline_1_a²)² of the mesh flavours
    in use (D₃ᵐ's, ν₃ᵐ's, then χ₃ᵐ's: the module order), in f32 in the plain
    version's order, which the H3 instances add to the advective CFL
    after the wave-speed root; 0 without them (the add leaves the rate
    bit for bit)."""
    f32 = np.float32
    sq = np.sqrt((inv[0] * inv[0] + inv[1] * inv[1]) + inv[2] * inv[2])
    adv2 = None
    nu3m, diff3m = hyper3_mesh_coefficients(cfg)
    for c in (diff3m, nu3m, chi_hyper3_coefficients(cfg)[1]):
        if c > 0.0:
            v = f32(c * PI5_1) * sq
            adv2 = v * v if adv2 is None else adv2 + v * v
    return f32(0.0) if adv2 is None else np.sqrt(adv2)


def _nblocks(shape, lib="fused_rhs"):
    t = (ctypes.c_int * 3)()
    _build.load(lib).pc_tile_shape(ctypes.addressof(t))
    n = 1
    for s, b in zip(shape, t):
        n *= -(-s // b)
    return n


# the instances of csrc/fused_rhs.cu's template, in pc_flagship_attrs order
FLAGSHIP_INSTANCES = (
    "rhs_first", "rhs_first_fake", "rhs_tail_defer", "rhs_tail_defer_fake",
    "rhs_tail_last kick", "rhs_tail_last", "rhs_tail_last_fake kick",
    "rhs_tail_last_fake", "rhs_tail_mid", "rhs_tail_defer_last kick",
    "rhs_tail_defer_last")


def library_instances(lib):
    """Instance name (its launch name first) -> ``pc_flagship_attrs``
    index of each instance of the template's library ``lib``: +16 with
    rotation (" rot"), +32 with the del6 terms (H3), +64 with chi-const
    (CHI), +128 with the upwinding (UPW, launch names with _upw; never
    beside H3), +256 with the shock diffusivities (SHK, launch names with
    _sd after _upw: the twin of each instance of the builds with the shock
    slot).  The periodic builds have the five kernels (and the kick's)
    with H3 (launch names with _h3), only the isothermal MHD build K8 (no
    rotation or H3); the shock builds have their two kernels with H3
    (" h3"), the z-ghosted builds theirs with CHI (launch names with _chi;
    the builds with ss only) and with H3 (_h3), each with or without the
    other; those with the shock slot have no H3 instance, and a SHK twin
    (_sd) of each of the others."""
    rot = (("", 0), (" rot", 16))
    if lib in AUX_KERNELS:
        return {kernel + upw + sd + flag + h3: which + r + x + z
                for kernel, which in zip(AUX_KERNELS[lib], (0, 8))
                for upw, h3, x in (("", "", 0), ("", " h3", 32),
                                   ("_upw", "", 128))
                for sd, z in zip(_sd_flags(lib), (0, 256))
                for flag, r in rot}
    if lib in ZG_KERNELS:
        chis = (("", 0), ("_chi", 64))[:1 + (lib in ZG_CHI_LIBRARIES)]
        bits = {"": 0, "_h3": 32, "_upw": 128}
        return {kernel + chi + h3 + sd + flag: which + r + x + bits[h3] + z
                for kernel, which in zip(ZG_KERNELS[lib], (0, 8))
                for chi, x in chis
                for h3 in _zg_flags(lib)
                for sd, z in zip(_sd_flags(lib), (0, 256))
                for flag, r in rot}
    sfx = _SUFFIX[lib]
    out = {}
    for which, name in enumerate(FLAGSHIP_INSTANCES):
        kernel, _, kick = name.partition(" ")
        if "fake" in name:
            if not sfx:
                out[name] = which
            continue
        for h3, x in (("", 0), ("_h3", 32), ("_upw", 128)):
            for flag, r in rot:
                out[(kernel + sfx + h3 + " " + kick).strip() + flag] = \
                    which + r + x
    return out


ATTR_KEYS = ("registers", "local_bytes", "static_smem", "dynamic_smem",
             "blocks_per_sm")


def flagship_attrs(lib="fused_rhs"):
    """Instance name -> its registers and local (spill and stack) bytes per
    thread, static and dynamic shared bytes per block, and resident blocks
    per SM, as the CUDA runtime reports them for the current card, for
    the flagship template's library ``lib``."""
    so = _build.load(lib)
    out = {}
    for name, which in library_instances(lib).items():
        a = (ctypes.c_int * len(ATTR_KEYS))()
        rc = so.pc_flagship_attrs(which, ctypes.addressof(a))
        if rc != 0:
            raise RuntimeError(f"pc_flagship_attrs({name}): CUDA error {rc}")
        out[name] = dict(zip(ATTR_KEYS, a))
    return out


def _check(t, shape, what):
    if t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: need a contiguous float32 tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def _launch(name, fa, *args, lib="fused_rhs", entry=None, after=()):
    """Launch ``pc_<entry>`` (default ``pc_<name>``) of ``lib`` on fa's
    stream, and count it under ``name``; ``after`` are the arguments that
    follow the stream."""
    fn = "pc_" + (entry or name)
    with torch.cuda.device(fa.device):
        stream = torch.cuda.current_stream(fa.device).cuda_stream
        rc = getattr(_build.load(lib), fn)(*args, stream, *after)
    if rc != 0:
        raise RuntimeError(f"{fn} ({lib}): CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def _dispatch(fa):
    """True for a CUDA tensor (kernel), False for a CPU one (plain)."""
    if fa.is_cuda:
        return True
    if fa.device.type != "cpu":
        raise NotImplementedError(f"no fused kernel for device {fa.device}")
    return False


def _flagship_check(model, fa, df=None, coef=None, fake=False):
    """The library of ``model``'s flagship kernels, after checking their
    inputs."""
    p = kernel_params(model)
    lib = flagship_library(model)
    shape = (model.reg.nvar, p.nx, p.ny, p.nz)
    _check(fa, shape, "fa")
    if df is not None:
        _check(df, shape, "df")
    if coef is not None:
        _check(coef, (3,), "coef")
    if fake and lib != "fused_rhs":
        raise NotImplementedError("K8: the MHD flagship layout only")
    return lib


def _flagship_launch(name, lib, model, fa, *args, fake=False, after=()):
    """Launch the flagship template's entry ``name`` (its K8 variant with
    ``fake``) of library ``lib``, counted under that library's launch
    name; ``args`` follow the constants and ``fa``, ``after`` the stream,
    and then, but for K8, g_z(z) and the continuous forcing."""
    name += "_fake" if fake else ""
    sfx = _SUFFIX[lib] + ("" if fake else _flag_suffix(model))
    if not fake:
        after = after + _terms(model)
    _launch(name + sfx, fa, ctypes.addressof(kernel_params(model)),
            fa.data_ptr(), *args, lib=lib, entry=name, after=after)


def _visx_check(model, lib, entry):
    """Raise where ``model``'s flavours of visx would launch the instance
    built without them (``visx_spills`` in csrc/fused_rhs.cu: it would
    spill): the 4-field hydro build's K1 UPW."""
    p = kernel_params(model)
    if p.visx and lib == "fused_rhs_hydro" and entry == "rhs_first" \
            and any(p.upw):
        raise NotImplementedError(
            f"fused kernels: {entry} of {lib} with upwinding is built "
            "without Viscosity's other flavours and diffrho (it would "
            "spill with them)")


def rhs_first(model, fa, fake=False):
    """K1: replaces ``kernel`` + ``_dma_tile_wrap`` (fused_rhs.py:306, wrap
    mode); K8 with ``fake`` (the ``PC_FAKE_RHS`` branch, :127-133).
    Returns (df, 0-d max of 1/dt).  The kernel writes one maximum per
    block of its grid, whose extent pc_tile_shape gives."""
    if not _dispatch(fa):
        return rhs_first_plain(model, fa, fake)
    lib = _flagship_check(model, fa, fake=fake)
    if not fake:
        _visx_check(model, lib, "rhs_first")
    df = torch.empty_like(fa)
    blk = fa.new_empty(_nblocks(fa.shape[1:], lib))
    _flagship_launch("rhs_first", lib, model, fa, df.data_ptr(),
                     blk.data_ptr(), fake=fake)
    return df, torch.amax(blk)


def rhs_tail_defer(model, fa, df1, coef, fake=False):
    """K2: replaces ``kernel_tail(defer_prev=True)`` (fused_rhs.py:379);
    K8 with ``fake``.  Returns (df2, f2)."""
    if not _dispatch(fa):
        return rhs_tail_defer_plain(model, fa, df1, coef, fake)
    lib = _flagship_check(model, fa, df1, coef, fake)
    df2 = torch.empty_like(fa)
    f2 = torch.empty_like(fa)
    _flagship_launch("rhs_tail_defer", lib, model, fa, df1.data_ptr(),
                     coef.data_ptr(), df2.data_ptr(), f2.data_ptr(),
                     fake=fake)
    return df2, f2


def rhs_tail_mid(model, fa, df_prev, coef):
    """K3′: the middle substeps of 2N-RK4, which the JAX step builds as
    ``kernel_upd`` + ``_dma_tile_wrap`` (fused_rhs.py:331, :677).  Returns
    (df, f); df is df_prev's buffer, overwritten."""
    if not _dispatch(fa):
        return rhs_tail_mid_plain(model, fa, df_prev, coef)
    lib = _flagship_check(model, fa, df_prev, coef)
    f = torch.empty_like(fa)
    _flagship_launch("rhs_tail_mid", lib, model, fa, df_prev.data_ptr(),
                     coef.data_ptr(), df_prev.data_ptr(), f.data_ptr())
    return df_prev, f


def _tail_last(name, model, fa, dfin, coef, kick, fake=False):
    lib = _flagship_check(model, fa, dfin, coef, fake)
    if kick is not None:
        _check(kick, (12,), "kick")
    zc = model.grid.z
    _check(zc, fa.shape[3:], "z")
    f = torch.empty_like(fa)
    # scratch for the sines and cosines of the kick's phases along each
    # axis, which the entry point fills before its march
    tab = None if kick is None else fa.new_empty(2 * sum(fa.shape[1:]))
    _flagship_launch(name, lib, model, fa, dfin.data_ptr(), coef.data_ptr(),
                     None if kick is None else kick.data_ptr(),
                     zc.data_ptr(), f.data_ptr(), fake=fake,
                     after=(None if tab is None else tab.data_ptr(),))
    return f


def rhs_tail_last(model, fa, df2, coef, kick=None, fake=False):
    """K3: replaces ``kernel_tail(last=True, with_kick=...)``
    (fused_rhs.py:379, kick at :429-466); K8 with ``fake``.  Returns f3."""
    if not _dispatch(fa):
        return rhs_tail_last_plain(model, fa, df2, coef, kick, fake)
    return _tail_last("rhs_tail_last", model, fa, df2, coef, kick, fake)


def rhs_tail_defer_last(model, fa, df1, coef, kick=None):
    """K2L: replaces ``kernel_tail(defer_prev=True, last=True,
    with_kick=...)`` (fused_rhs.py:379), the one tail substep of 2N-RK2.
    Returns f."""
    if not _dispatch(fa):
        return rhs_tail_defer_last_plain(model, fa, df1, coef, kick)
    return _tail_last("rhs_tail_defer_last", model, fa, df1, coef, kick)


def _zg_inputs(model, fa, zlo, zhi, df_prev=None, coef=None):
    """(library, its launch names (``zg_kernels``), the output shape, the
    inputs after the stream: the slabs and the z profiles with g_z) of
    ``model``'s z-ghosted build, after checking every input: fa and the
    slabs ghosted in x and y for a shear build."""
    p = kernel_params(model)
    lib = zg_library(model)
    shape = (model.reg.nvar, p.nx, p.ny, p.nz)
    g2 = 2 * NGHOST if model.zg_xy else 0
    src = (model.reg.nf, p.nx + g2, p.ny + g2)
    _check(fa, src + (p.nz,), "fa")
    for name, t in (("zlo", zlo), ("zhi", zhi)):
        _check(t, src + (NGHOST,), name)
    if df_prev is not None:
        _check(df_prev, shape, "df_prev")
    if coef is not None:
        _check(coef, (2,), "coef")
    prof_c, prof_h, grav = map(_ptr, zg_profiles(model))
    return lib, zg_kernels(model), shape, (
        zlo.data_ptr(), zhi.data_ptr(), prof_c, prof_h,
        _ptr(kprof_vector(model)), grav, _ptr(fcont_tensor(model)))


def rhs_zg(model, fa, zlo, zhi):
    """K6 (K6m with aa; K6s, K6ms with Shear; K6k, K6mk with the shock
    slot; K6i, K6mi, K6si, K6msi without ss): replaces ``kernel_zg`` +
    ``_fetch_zg`` (fused_rhs.py:317, :301), on the interior stack (with
    Shear: the x/y-ghosted one; with the shock slot: all nf slots) and its
    z-halo slabs.  Returns (df, 0-d max of 1/dt)."""
    if not _dispatch(fa):
        return zg_plain(model)[0](model, fa, zlo, zhi)
    lib, (name, _), shape, after = _zg_inputs(model, fa, zlo, zhi)
    df = fa.new_empty(shape)
    blk = fa.new_empty(_nblocks(shape[1:], lib))
    _launch(name, fa, ctypes.addressof(kernel_params(model)), fa.data_ptr(),
            df.data_ptr(), blk.data_ptr(), lib=lib, entry="rhs_first",
            after=after)
    return df, torch.amax(blk)


def rhs_zg_upd(model, fa, zlo, zhi, df_prev, coef):
    """K7 (K7m with aa; K7s, K7ms with Shear; K7k, K7mk with the shock
    slot; K7i, K7mi, K7si, K7msi without ss): replaces ``kernel_zg_upd``
    (fused_rhs.py:349).  Returns (df, f) of the evolved fields; df is
    df_prev's buffer, overwritten."""
    if not _dispatch(fa):
        return zg_plain(model)[1](model, fa, zlo, zhi, df_prev, coef)
    lib, (_, name), shape, after = _zg_inputs(model, fa, zlo, zhi, df_prev,
                                              coef)
    f = fa.new_empty(shape)
    _launch(name, fa, ctypes.addressof(kernel_params(model)),
            fa.data_ptr(), df_prev.data_ptr(), coef.data_ptr(),
            df_prev.data_ptr(), f.data_ptr(), lib=lib,
            entry="rhs_tail_mid", after=after)
    return df_prev, f


def _aux_check(model, fa, shear, df_prev=None, coef=None):
    """(library, its launch names, output shape) of ``model``'s shock or
    shear build after checking the inputs: fa the state of all nf slots,
    ghosted in x and y for a shear build (``shear``), which must be the
    kind that ``model`` takes."""
    p = kernel_params(model)
    lib = aux_library(model)
    names = aux_kernels(model)
    if (_AUX_BUILDS[lib][2] == _ZROLL) != shear:
        raise NotImplementedError(
            f"{names[0]} runs this model, not "
            f"{'rhs_zroll' if shear else 'rhs_wrap_shock'}")
    g2 = 2 * NGHOST if shear else 0
    _check(fa, (model.reg.nf, p.nx + g2, p.ny + g2, p.nz),
           "fg" if shear else "fa")
    shape = (model.reg.nvar, p.nx, p.ny, p.nz)
    if df_prev is not None:
        _check(df_prev, shape, "df_prev")
    if coef is not None:
        _check(coef, (2,), "coef")
    return lib, names, shape


def _aux_first(model, fa, shear):
    """K4 or K1s (of the model's layout): the build's ``pc_rhs_first``."""
    lib, (name, _), shape = _aux_check(model, fa, shear)
    df = fa.new_empty(shape)
    blk = fa.new_empty(_nblocks(shape[1:], lib))
    _launch(name, fa, ctypes.addressof(kernel_params(model)), fa.data_ptr(),
            df.data_ptr(), blk.data_ptr(), lib=lib, entry="rhs_first",
            after=_terms(model))
    return df, torch.amax(blk)


def _aux_upd(model, fa, df_prev, coef, shear):
    """K5 or K5w (of the model's layout): the build's ``pc_rhs_tail_mid``;
    the new df overwrites df_prev."""
    lib, (_, name), shape = _aux_check(model, fa, shear, df_prev, coef)
    f = df_prev.new_empty(shape)
    _launch(name, fa, ctypes.addressof(kernel_params(model)), fa.data_ptr(),
            df_prev.data_ptr(), coef.data_ptr(), df_prev.data_ptr(),
            f.data_ptr(), lib=lib, entry="rhs_tail_mid",
            after=_terms(model))
    return df_prev, f


def rhs_zroll(model, fg):
    """K4: replaces ``kernel`` + ``_dma_tile`` (fused_rhs.py:306, :193,
    zroll mode).  Returns (df, 0-d max of 1/dt)."""
    if not _dispatch(fg):
        return rhs_zroll_plain(model, fg)
    return _aux_first(model, fg, True)


def rhs_zroll_upd(model, fg, df_prev, coef):
    """K5: replaces ``kernel_upd`` (fused_rhs.py:331) with the ``_dma_tile``
    fetch.  Returns (df, f); df is df_prev's buffer, overwritten."""
    if not _dispatch(fg):
        return rhs_zroll_upd_plain(model, fg, df_prev, coef)
    return _aux_upd(model, fg, df_prev, coef, True)


def rhs_wrap_shock(model, fa):
    """K1s: replaces ``kernel`` + ``_dma_tile_wrap`` with the shock slot
    (fused_rhs.py:306, :238; wrap mode with an aux module).  Returns (df,
    0-d max of 1/dt)."""
    if not _dispatch(fa):
        return rhs_wrap_shock_plain(model, fa)
    return _aux_first(model, fa, False)


def rhs_wrap_shock_upd(model, fa, df_prev, coef):
    """K5w: replaces ``kernel_upd`` + ``_dma_tile_wrap`` (fused_rhs.py:331,
    :238; call :677).  Returns (df, f); df is df_prev's buffer,
    overwritten."""
    if not _dispatch(fa):
        return rhs_wrap_shock_upd_plain(model, fa, df_prev, coef)
    return _aux_upd(model, fa, df_prev, coef, False)
