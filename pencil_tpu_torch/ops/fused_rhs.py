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
model's field layout (``flagship_library``).

Stratified convection (zghost mode, ``csrc/zghost_rhs.cu``), on the stack
ghosted in all three axes by ``fill_ghosts`` (5, nx+6, ny+6, nz+6):

  rhs_zg           K6  df = RHS(f), max of the CFL 1/dt
  rhs_zg_upd       K7  df ← α·df_prev + RHS(f), written over df_prev;
                       f ← f_interior + βΔt·df, a fresh tensor

The shearing box (zroll mode, ``csrc/zroll_rhs.cu``), on the stack of all
8 slots (uu, lnrho, aa, shock) ghosted in x and y by ``fill_ghosts`` with
shear-periodic x faces, z unghosted and periodic (8, nx+6, ny+6, nz):

  rhs_zroll        K4  df = RHS(f), max of the CFL 1/dt
  rhs_zroll_upd    K5  df ← α·df_prev + RHS(f), written over df_prev;
                       f ← f_interior + βΔt·df, a fresh (7, nx, ny, nz)

The shocked periodic box (wrap_aux mode, the same source without the shear
terms), on the raw periodic 8-slot state (8, nx, ny, nz) after the shock
pre-pass:

  rhs_wrap_shock       K1s  df = RHS(f), max of the CFL 1/dt
  rhs_wrap_shock_upd   K5w  K5's update on the raw state

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
from ..physics.base import TimestepAccum
from ..physics.pencils import Pencils
from . import _build
from .stencil import BIDIAG, BIDIAG_TAPS, NGHOST, i, paired_weights

# Nothing here should reach cuDNN or a matmul, but a stencil written as a
# conv3d would silently drop to TF32 on Hopper and lose f32 parity.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# Launches of each kernel: a wrapper adds one where it launches, and
# nowhere else, so a run can show that its main path went through them.
LAUNCHES = dict.fromkeys((
    "rhs_first", "rhs_tail_defer", "rhs_tail_last", "rhs_tail_mid",
    "rhs_tail_defer_last", "rhs_first_fake", "rhs_tail_defer_fake",
    "rhs_tail_last_fake", "rhs_first_hydro", "rhs_tail_defer_hydro",
    "rhs_tail_last_hydro", "rhs_tail_mid_hydro", "rhs_tail_defer_last_hydro",
    "rhs_first_ent", "rhs_tail_defer_ent", "rhs_tail_last_ent",
    "rhs_tail_mid_ent", "rhs_tail_defer_last_ent", "rhs_first_hydro_ent",
    "rhs_tail_defer_hydro_ent", "rhs_tail_last_hydro_ent",
    "rhs_tail_mid_hydro_ent", "rhs_tail_defer_last_hydro_ent",
    "rhs_zg", "rhs_zg_upd", "rhs_zroll", "rhs_zroll_upd", "rhs_wrap_shock",
    "rhs_wrap_shock_upd"), 0)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def rhs_zg_plain(model, fg):
    """K6's plain version: (df, 0-d max of 1/dt) on the ghosted stack."""
    return rhs_plain(model, fg, ghosted=True)


def rhs_zg_upd_plain(model, fg, df_prev, coef):
    """K7's plain version: (df, f); df is written over df_prev."""
    alpha, bdt = coef[0], coef[1]
    dfa, _ = rhs_plain(model, fg, want_dt1=False, ghosted=True)
    df_prev.copy_(alpha * df_prev + dfa)
    return df_prev, i(fg[: model.reg.nvar]) + bdt * df_prev


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
# the suffix of each library's launch names
_SUFFIX = {"fused_rhs": "", "fused_rhs_hydro": "_hydro",
           "fused_rhs_ent": "_ent", "fused_rhs_hydro_ent": "_hydro_ent"}
# the modules whose terms the template implements (forcing rides along as
# the kick); a layout with any other module (gravity, shear, shock) is not
# the template's
_TEMPLATE_MODULES = frozenset(("eos", "density", "hydro", "viscosity",
                               "magnetic", "entropy", "forcing"))


def flagship_library(model) -> str:
    """The library of the flagship template whose field layout is
    ``model``'s: 'fused_rhs' (uu, lnrho, aa), 'fused_rhs_hydro' (uu,
    lnrho), 'fused_rhs_ent' (uu, lnrho, ss, aa) or 'fused_rhs_hydro_ent'
    (uu, lnrho, ss); raises for any other layout, and for a module or an
    entropy layer profile that the template has no terms for."""
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


def launch_suffix(model) -> str:
    """The suffix of the launch names of ``model``'s flagship-template
    library: '', '_hydro', '_ent' or '_hydro_ent'."""
    return _SUFFIX[flagship_library(model)]


def kernel_params(model) -> PcParams:
    """The kernel constants of ``model``, rounded to f32 in the same order
    as the plain version computes them; built once per model."""
    p = model.__dict__.get("_pc_params")
    if p is not None:
        return p
    cfg, gs = model.cfg, model.cfg.grid
    flagship_library(model)
    f32 = np.float32
    inv = np.array(inverse_spacings(gs), f32)
    invsq = inv * inv
    dxyz2 = (invsq[0] + invsq[1]) + invsq[2]
    nu = cfg.module("viscosity").nu
    mag = cfg.module("magnetic")
    eta = mag.eta if mag is not None else 0.0
    eos = model.eos
    ent = cfg.module("entropy")
    chi = ent.chi if ent is not None and ent.chi_conduction else 0.0
    hcond0 = ent.hcond0 if ent is not None and ent.conduction else 0.0
    # the constant diffusive rates; K-const's K·γ/(ρ·cp) joins per point
    maxdiffus = max([v for v in (nu, eta, chi * eos.gamma) if v > 0.0],
                    default=0.0)
    dif = f32(maxdiffus) * dxyz2 / f32(cfg.time.cdtv) if maxdiffus else f32(0)
    heats = ent is not None
    hyd = cfg.module("hydro")
    x0, y0 = _node0(gs)
    wm = [sgn * c for c in BIDIAG for _, _, sgn in BIDIAG_TAPS]
    p = PcParams(
        nx=gs.nx, ny=gs.ny, nz=gs.nz, isothermal=int(eos.gamma == 1.0),
        w1=(ctypes.c_float * 3)(*paired_weights(1)),
        w2=(ctypes.c_float * 3)(*paired_weights(2)),
        wm=(ctypes.c_float * 12)(*wm),
        inv=(ctypes.c_float * 3)(*inv), invsq=(ctypes.c_float * 3)(*invsq),
        nu=max(nu, 0.0), eta=max(eta, 0.0),
        cs20=eos.cs20, gm1=eos.gamma - 1.0, lnrho0=eos.lnrho0,
        dxyz2=dxyz2, cdt=cfg.time.cdt, dif=dif,
        x0=x0, y0=y0, dx=gs.dx, dy=gs.dy,
        om=(ctypes.c_float * 3)(*(hyd.omega_vector() if hyd.Omega != 0.0
                                  else (0, 0, 0))),
        g_cp=eos.gamma / eos.cp, cp=eos.cp, gamma=eos.gamma,
        lnTT0=eos.lnTT0, cpchi=eos.cp * chi, hcond0=hcond0,
        two_nu=2.0 * max(nu, 0.0) if heats else 0.0,
        eta_heat=max(eta, 0.0) if heats and mag is not None
        and mag.lohmic_heat else 0.0,
        maxdif=maxdiffus, cdtv=cfg.time.cdtv)
    model.__dict__["_pc_params"] = p
    return p


class ZgParams(ctypes.Structure):
    """Mirror of ``struct ZgParams`` in csrc/zghost_rhs.cu."""

    _fields_ = [
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("has_visc", ctypes.c_int), ("has_cond", ctypes.c_int),
        ("has_cool", ctypes.c_int), ("has_heat", ctypes.c_int),
        ("w1", ctypes.c_float * 3), ("w2", ctypes.c_float * 3),
        ("wm", ctypes.c_float * 12),
        ("inv", ctypes.c_float * 3), ("invsq", ctypes.c_float * 3),
        ("nu", ctypes.c_float), ("two_nu", ctypes.c_float),
        ("third", ctypes.c_float), ("gravz", ctypes.c_float),
        ("cs20", ctypes.c_float), ("gm1", ctypes.c_float),
        ("g_cp", ctypes.c_float), ("cp", ctypes.c_float),
        ("gamma", ctypes.c_float), ("lnrho0", ctypes.c_float),
        ("lnTT0", ctypes.c_float), ("hcond0", ctypes.c_float),
        ("cool", ctypes.c_float), ("cs2c", ctypes.c_float),
        ("heat_norm", ctypes.c_float),
        ("dxyz2", ctypes.c_float), ("cdt", ctypes.c_float),
        ("cdtv", ctypes.c_float),
    ]


# the zghost kernels' fixed field layout: the conv-slab registry order
_ZG_LAYOUT = {"uu": slice(0, 3), "lnrho": slice(3, 4), "ss": slice(4, 5)}


def zg_params(model):
    """(ZgParams, cooling profile, heating profile) of ``model``: the
    kernel constants rounded to f32 as the plain version rounds them, and
    the z profiles as device vectors (zeros where a layer is off); built
    once per model."""
    p = model.__dict__.get("_zg_params")
    if p is not None:
        return p
    reg, cfg, gs = model.reg, model.cfg, model.cfg.grid
    if reg.nvar != 5 or reg.nf != 5 or any(
            reg.slice(k) != v for k, v in _ZG_LAYOUT.items()):
        raise NotImplementedError("zghost kernels: conv-slab layout only")
    eos, ent = model.eos, cfg.module("entropy")
    nu = cfg.module("viscosity").nu
    inv = np.array(inverse_spacings(gs), np.float32)
    invsq = inv * inv
    z = model.grid.z
    prof_c, prof_h = ent.heat_cool_profiles(z, gs)
    wm = [sgn * c for c in BIDIAG for _, _, sgn in BIDIAG_TAPS]
    params = ZgParams(
        nx=gs.nx, ny=gs.ny, nz=gs.nz, has_visc=int(nu > 0.0),
        has_cond=int(ent.conduction), has_cool=int(prof_c is not None),
        has_heat=int(prof_h is not None),
        w1=(ctypes.c_float * 3)(*paired_weights(1)),
        w2=(ctypes.c_float * 3)(*paired_weights(2)),
        wm=(ctypes.c_float * 12)(*wm),
        inv=(ctypes.c_float * 3)(*inv), invsq=(ctypes.c_float * 3)(*invsq),
        nu=max(nu, 0.0), two_nu=2.0 * max(nu, 0.0), third=1.0 / 3.0,
        gravz=cfg.module("gravity").gravz,
        cs20=eos.cs20, gm1=eos.gamma - 1.0, g_cp=eos.gamma / eos.cp,
        cp=eos.cp, gamma=eos.gamma, lnrho0=eos.lnrho0, lnTT0=eos.lnTT0,
        hcond0=ent.hcond0, cool=ent.cool, cs2c=ent.cs2c(eos),
        heat_norm=ent.heat_norm(gs) if prof_h is not None else 0.0,
        dxyz2=(invsq[0] + invsq[1]) + invsq[2], cdt=cfg.time.cdt,
        cdtv=cfg.time.cdtv)
    zero = torch.zeros_like(z)
    p = (params, (zero if prof_c is None else prof_c).contiguous(),
         (zero if prof_h is None else prof_h).contiguous())
    model.__dict__["_zg_params"] = p
    return p


class ZrParams(ctypes.Structure):
    """Mirror of ``struct ZrParams`` in csrc/zroll_rhs.cu."""

    _fields_ = [
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("isothermal", ctypes.c_int),
        ("w1", ctypes.c_float * 3), ("w2", ctypes.c_float * 3),
        ("w6", ctypes.c_float * 3), ("wm", ctypes.c_float * 12),
        ("inv", ctypes.c_float * 3), ("invsq", ctypes.c_float * 3),
        ("inv6", ctypes.c_float * 3),
        ("nu", ctypes.c_float), ("nu_shock", ctypes.c_float),
        ("nu3", ctypes.c_float), ("eta", ctypes.c_float),
        ("eta3", ctypes.c_float), ("diff3", ctypes.c_float),
        ("om", ctypes.c_float * 3), ("S", ctypes.c_float),
        ("cs20", ctypes.c_float), ("gm1", ctypes.c_float),
        ("lnrho0", ctypes.c_float),
        ("dxyz2", ctypes.c_float), ("cdt", ctypes.c_float),
        ("cdtv", ctypes.c_float), ("dif3", ctypes.c_float),
        ("x0", ctypes.c_float), ("dx", ctypes.c_float),
    ]


# the zroll kernels' fixed field layout: the shear-box registry order
_ZR_LAYOUT = {"uu": slice(0, 3), "lnrho": slice(3, 4), "aa": slice(4, 7),
              "shock": slice(7, 8)}


def zr_params(model) -> ZrParams:
    """The zroll kernel constants of ``model``, each the f32 rounding of
    the value the plain version multiplies by; built once per model."""
    p = model.__dict__.get("_zr_params")
    if p is not None:
        return p
    reg, cfg, gs = model.reg, model.cfg, model.cfg.grid
    if reg.nvar != 7 or reg.nf != 8 or any(
            reg.slice(k) != v for k, v in _ZR_LAYOUT.items()):
        raise NotImplementedError("zroll kernels: shear-box layout only")
    f32 = np.float32
    inv = np.array(inverse_spacings(gs), f32)
    invsq = inv * inv
    inv6 = pow6(inv)
    dxyz2 = (invsq[0] + invsq[1]) + invsq[2]
    nu, nu_shock, nu3 = cfg.module("viscosity").coefficients()
    mag, den = cfg.module("magnetic"), cfg.module("density")
    eta, eta3 = max(mag.eta, 0.0), max(mag.eta_hyper3, 0.0)
    diff3 = max(den.diffrho_hyper3, 0.0)
    # the constant hyper-diffusive CFL rate max(ν₃, η₃, D₃)·dxyz₆/cdtv3
    m3 = max(nu3, eta3, diff3)
    dxyz6 = (inv6[0] + inv6[1]) + inv6[2]
    dif3 = f32(m3) * dxyz6 / f32(cfg.time.cdtv3) if m3 > 0.0 else f32(0)
    hyd = cfg.module("hydro")
    eos = model.eos
    x0, _ = _node0(gs)
    wm = [sgn * c for c in BIDIAG for _, _, sgn in BIDIAG_TAPS]
    fl3 = ctypes.c_float * 3
    p = ZrParams(
        nx=gs.nx, ny=gs.ny, nz=gs.nz, isothermal=int(eos.gamma == 1.0),
        w1=fl3(*paired_weights(1)), w2=fl3(*paired_weights(2)),
        w6=fl3(*paired_weights(6)), wm=(ctypes.c_float * 12)(*wm),
        inv=fl3(*inv), invsq=fl3(*invsq), inv6=fl3(*inv6),
        nu=nu, nu_shock=nu_shock, nu3=nu3, eta=eta, eta3=eta3, diff3=diff3,
        om=fl3(*(hyd.omega_vector() if hyd.Omega != 0.0 else (0, 0, 0))),
        S=cfg.module("shear").S if cfg.module("shear") else 0.0,
        cs20=eos.cs20, gm1=eos.gamma - 1.0, lnrho0=eos.lnrho0,
        dxyz2=dxyz2, cdt=cfg.time.cdt, cdtv=cfg.time.cdtv, dif3=dif3,
        x0=x0, dx=gs.dx)
    model.__dict__["_zr_params"] = p
    return p


def _nblocks(shape, lib="fused_rhs", fn="pc_tile_shape"):
    t = (ctypes.c_int * 3)()
    getattr(_build.load(lib), fn)(ctypes.addressof(t))
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
    """Launch name -> ``pc_flagship_attrs`` index of each instance of the
    template's library ``lib`` (only the isothermal MHD build has K8)."""
    sfx = _SUFFIX[lib]
    out = {}
    for which, name in enumerate(FLAGSHIP_INSTANCES):
        if sfx and "fake" in name:
            continue
        kernel, _, flag = name.partition(" ")
        out[(kernel + sfx + " " + flag).strip()] = which
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


def _launch(name, fa, *args, lib="fused_rhs", entry=None):
    """Launch ``pc_<entry>`` (default ``pc_<name>``) of ``lib`` on fa's
    stream, and count it under ``name``."""
    fn = "pc_" + (entry or name)
    with torch.cuda.device(fa.device):
        stream = torch.cuda.current_stream(fa.device).cuda_stream
        rc = getattr(_build.load(lib), fn)(*args, stream)
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


def _flagship_launch(name, lib, model, fa, *args, fake=False):
    """Launch the flagship template's entry ``name`` (its K8 variant with
    ``fake``) of library ``lib``, counted under that library's launch
    name; ``args`` follow the constants and ``fa``."""
    name += "_fake" if fake else ""
    _launch(name + _SUFFIX[lib], fa, ctypes.addressof(kernel_params(model)),
            fa.data_ptr(), *args, lib=lib, entry=name)


def rhs_first(model, fa, fake=False):
    """K1: replaces ``kernel`` + ``_dma_tile_wrap`` (fused_rhs.py:306, wrap
    mode); K8 with ``fake`` (the ``PC_FAKE_RHS`` branch, :127-133).
    Returns (df, 0-d max of 1/dt).  The kernel writes one maximum per
    block of its grid, whose extent pc_tile_shape gives."""
    if not _dispatch(fa):
        return rhs_first_plain(model, fa, fake)
    lib = _flagship_check(model, fa, fake=fake)
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
    _flagship_launch(name, lib, model, fa, dfin.data_ptr(), coef.data_ptr(),
                     None if kick is None else kick.data_ptr(),
                     zc.data_ptr(), f.data_ptr(), fake=fake)
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


def rhs_zg(model, fg):
    """K6: replaces ``kernel_zg`` + ``_fetch_zg``/``_halo_tile``/
    ``_window_halo`` (fused_rhs.py:317, :292-304, :512).  Returns (df,
    0-d max of 1/dt)."""
    if not _dispatch(fg):
        return rhs_zg_plain(model, fg)
    p, prof_c, prof_h = zg_params(model)
    g2 = 2 * NGHOST
    _check(fg, (5, p.nx + g2, p.ny + g2, p.nz + g2), "fg")
    df = fg.new_empty((5, p.nx, p.ny, p.nz))
    blk = fg.new_empty(_nblocks((p.nx, p.ny, p.nz), "zghost_rhs",
                                "pc_zg_tile_shape"))
    _launch("rhs_zg", fg, ctypes.addressof(p), fg.data_ptr(),
            prof_c.data_ptr(), prof_h.data_ptr(), df.data_ptr(),
            blk.data_ptr(), lib="zghost_rhs")
    return df, torch.amax(blk)


def rhs_zg_upd(model, fg, df_prev, coef):
    """K7: replaces ``kernel_zg_upd`` (fused_rhs.py:349).  Returns (df,
    f); df is df_prev's buffer, overwritten."""
    if not _dispatch(fg):
        return rhs_zg_upd_plain(model, fg, df_prev, coef)
    p, prof_c, prof_h = zg_params(model)
    g2 = 2 * NGHOST
    _check(fg, (5, p.nx + g2, p.ny + g2, p.nz + g2), "fg")
    _check(df_prev, (5, p.nx, p.ny, p.nz), "df_prev")
    _check(coef, (2,), "coef")
    fa = df_prev.new_empty(df_prev.shape)
    _launch("rhs_zg_upd", fg, ctypes.addressof(p), fg.data_ptr(),
            prof_c.data_ptr(), prof_h.data_ptr(), df_prev.data_ptr(),
            coef.data_ptr(), df_prev.data_ptr(), fa.data_ptr(),
            lib="zghost_rhs")
    return df_prev, fa


def _zr_shapes(model, fg):
    p = zr_params(model)
    g2 = 2 * NGHOST
    _check(fg, (8, p.nx + g2, p.ny + g2, p.nz), "fg")
    return p, (7, p.nx, p.ny, p.nz)


def rhs_zroll(model, fg):
    """K4: replaces ``kernel`` + ``_dma_tile`` (fused_rhs.py:306, :193,
    zroll mode).  Returns (df, 0-d max of 1/dt)."""
    if not _dispatch(fg):
        return rhs_zroll_plain(model, fg)
    p, shape = _zr_shapes(model, fg)
    df = fg.new_empty(shape)
    blk = fg.new_empty(_nblocks(shape[1:], "zroll_rhs", "pc_zr_tile_shape"))
    _launch("rhs_zroll", fg, ctypes.addressof(p), fg.data_ptr(),
            df.data_ptr(), blk.data_ptr(), lib="zroll_rhs")
    return df, torch.amax(blk)


def rhs_zroll_upd(model, fg, df_prev, coef):
    """K5: replaces ``kernel_upd`` (fused_rhs.py:331) with the ``_dma_tile``
    fetch.  Returns (df, f); df is df_prev's buffer, overwritten."""
    if not _dispatch(fg):
        return rhs_zroll_upd_plain(model, fg, df_prev, coef)
    p, shape = _zr_shapes(model, fg)
    _check(df_prev, shape, "df_prev")
    _check(coef, (2,), "coef")
    fa = df_prev.new_empty(shape)
    _launch("rhs_zroll_upd", fg, ctypes.addressof(p), fg.data_ptr(),
            df_prev.data_ptr(), coef.data_ptr(), df_prev.data_ptr(),
            fa.data_ptr(), lib="zroll_rhs")
    return df_prev, fa


def _wrap_shock_shape(model, fa):
    p = zr_params(model)
    _check(fa, (8, p.nx, p.ny, p.nz), "fa")
    return p, (7, p.nx, p.ny, p.nz)


def rhs_wrap_shock(model, fa):
    """K1s: replaces ``kernel`` + ``_dma_tile_wrap`` with the shock slot
    (fused_rhs.py:306, :238; wrap mode with an aux module).  Returns (df,
    0-d max of 1/dt)."""
    if not _dispatch(fa):
        return rhs_wrap_shock_plain(model, fa)
    p, shape = _wrap_shock_shape(model, fa)
    df = fa.new_empty(shape)
    blk = fa.new_empty(_nblocks(shape[1:], "zroll_rhs", "pc_zr_tile_shape"))
    _launch("rhs_wrap_shock", fa, ctypes.addressof(p), fa.data_ptr(),
            df.data_ptr(), blk.data_ptr(), lib="zroll_rhs")
    return df, torch.amax(blk)


def rhs_wrap_shock_upd(model, fa, df_prev, coef):
    """K5w: replaces ``kernel_upd`` + ``_dma_tile_wrap`` (fused_rhs.py:331,
    :238; call :677).  Returns (df, f); df is df_prev's buffer,
    overwritten."""
    if not _dispatch(fa):
        return rhs_wrap_shock_upd_plain(model, fa, df_prev, coef)
    p, shape = _wrap_shock_shape(model, fa)
    _check(df_prev, shape, "df_prev")
    _check(coef, (2,), "coef")
    f = df_prev.new_empty(shape)
    _launch("rhs_wrap_shock_upd", fa, ctypes.addressof(p), fa.data_ptr(),
            df_prev.data_ptr(), coef.data_ptr(), df_prev.data_ptr(),
            f.data_ptr(), lib="zroll_rhs")
    return df_prev, f
