"""Named scalar diagnostics (counterpart of ``pencil_tpu/io/diagnostics.py``;
reference ``src/diagnostics.f90``: modules save into fname, printed by
``prints`` according to ``print.in``).

Each diagnostic is a named function over the ``Pencils`` container; the
requested set is evaluated in one call on the model's device and comes back
as 0-d tensors, so a caller can stack a row and copy it to the host once.
Ported are the columns of the turbulence runs: the state scalars ``it``,
``t``, ``dt``; hydro ``urms``, ``umax``, ``u2m``, the components' means,
squares, extrema and products (``uxm`` … ``uyuzm``), ``divum``,
``divu2m``, the vorticity's ``orms``, ``omax``, ``o2m``, the kinetic
helicity ``oum``, ``ekin``, ``EEK`` and the Mach numbers ``Marms``,
``Mamax``; density ``rhom``, ``rhomin``, ``rhomax``; thermodynamics
``ssm``, ``TTm``, ``csm``, ``ethm``; magnetic ``brms``, ``bmax``, ``b2m``,
``bm2``, ``bx2m`` … ``bz2m``, A's ``arms``, ``a2m``, ``axm`` … ``azm``,
``amax``, ``jrms``, ``jmax``, ``j2m``, ``jbm``, ``abm``, the Alfvén speed's
``vA2m``, ``vArms``, ``vAmax``, the mean fields ``bmx``, ``bmy``, ``bmz``,
``EEM`` and ``emag``, the extrema of B without B_ext ``bbxmax``,
``bbymax``, ``bbzmax`` and the EMF along the imposed field ``uxbm``; the
continuous forcing's work ``ufm`` and ``rufm``; the dissipation rates
``epsK`` and ``epsM``; the integrals ``ekintot`` and ``ethtot``; and the
thermal diffusivity's share of the time step ``dtchi``.
Plain torch: the JAX package computes them in jnp outside any kernel.  As there, the pencils read a ghost-filled
copy of the state (wraps and BCs, without the shear shift), and a shock slot
is rebuilt from the current fields first.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np
import torch

from ..physics.pencils import Pencils, b_ext
from ..physics.stratification import hcond_profile


def _staged_mean(x):
    """Mean taken one axis at a time, the last axis first: a flat f32
    reduction over many elements carries a systematic rounding bias, and
    the reference accumulates per pencil row too."""
    while x.ndim > 0:
        x = x.mean(dim=-1)
    return x


def _vmean(pen, x):
    """Volume mean; a plain mean on the port's Cartesian grids."""
    return _staged_mean(x)


def _vrms(pen, x):
    return torch.sqrt(_vmean(pen, x))


def _boxvol(pen):
    """Box volume with a degenerate axis (one grid point) weighing 1, not
    its length (reference box_vol, grid.f90:1667; the Cartesian row of the
    degenerate-axis weights, grid.f90:1050-1230)."""
    gs = pen.cfg.grid
    vol = 1.0
    for length, n in ((gs.Lx, gs.nx), (gs.Ly, gs.ny), (gs.Lz, gs.nz)):
        if n > 1:
            vol *= length
    return vol


def _zero(pen):
    return torch.zeros((), dtype=pen.f.dtype, device=pen.f.device)


DIAG_REGISTRY: Dict[str, Callable] = {}


def diag(name):
    def deco(fn):
        DIAG_REGISTRY[name] = fn
        return fn
    return deco


# ---- hydro ----------------------------------------------------------------
@diag("urms")
def _urms(pen, st):
    return _vrms(pen, pen.u2())


@diag("umax")
def _umax(pen, st):
    return torch.sqrt(pen.u2().max())


@diag("u2m")
def _u2m(pen, st):
    return _vmean(pen, pen.u2())


for _i, _c in enumerate("xyz"):
    DIAG_REGISTRY[f"u{_c}m"] = (
        lambda pen, st, i=_i: _vmean(pen, pen.uu()[i]))
    DIAG_REGISTRY[f"u{_c}2m"] = (
        lambda pen, st, i=_i: _vmean(pen, pen.uu()[i] ** 2))
    # the signed extrema of the raw component (hydro.f90:3991)
    DIAG_REGISTRY[f"u{_c}max"] = lambda pen, st, i=_i: pen.uu()[i].max()
    DIAG_REGISTRY[f"u{_c}min"] = lambda pen, st, i=_i: pen.uu()[i].min()
for _i, _j, _n in ((0, 1, "uxuym"), (0, 2, "uxuzm"), (1, 2, "uyuzm")):
    DIAG_REGISTRY[_n] = (
        lambda pen, st, i=_i, j=_j: _vmean(pen, pen.uu()[i] * pen.uu()[j]))


@diag("divum")
def _divum(pen, st):
    return _vmean(pen, pen.divu())


@diag("divu2m")
def _divu2m(pen, st):
    return _vmean(pen, pen.divu() ** 2)


def _o2(pen):
    oo = pen.oo()
    return oo[0] ** 2 + oo[1] ** 2 + oo[2] ** 2


@diag("orms")
def _orms(pen, st):
    return _vrms(pen, _o2(pen))


@diag("o2m")
def _o2m(pen, st):
    return _vmean(pen, _o2(pen))


@diag("omax")
def _omax(pen, st):
    return torch.sqrt(_o2(pen).max())


@diag("oum")
def _oum(pen, st):
    """Mean kinetic helicity <ω·u>."""
    oo, uu = pen.oo(), pen.uu()
    return _vmean(pen, oo[0] * uu[0] + oo[1] * uu[1] + oo[2] * uu[2])


@diag("ekin")
def _ekin(pen, st):
    """<½ρu²> (hydro.f90:4067 idiag_EEK prints the same)."""
    return 0.5 * _vmean(pen, pen.rho() * pen.u2())


DIAG_REGISTRY["EEK"] = _ekin


def _mach2(pen):
    return pen.u2() / torch.clamp(pen.cs2(), min=1e-30)


@diag("Marms")
def _marms(pen, st):
    """rms Mach number √<u²/cs²>."""
    return _vrms(pen, _mach2(pen))


@diag("Mamax")
def _mamax(pen, st):
    return torch.sqrt(_mach2(pen).max())


@diag("ekintot")
def _ekintot(pen, st):
    """∫½ρu² dV (an integral, not a mean)."""
    return 0.5 * _vmean(pen, pen.rho() * pen.u2()) * _boxvol(pen)


# ---- density --------------------------------------------------------------
@diag("rhom")
def _rhom(pen, st):
    return _vmean(pen, pen.rho())


@diag("rhomax")
def _rhomax(pen, st):
    return pen.rho().max()


@diag("rhomin")
def _rhomin(pen, st):
    return pen.rho().min()


# ---- entropy and thermodynamics --------------------------------------------
@diag("ssm")
def _ssm(pen, st):
    # a label no module claims prints 0 (reference parse_name)
    if "ss" not in pen.reg.slots:
        return _zero(pen)
    return _vmean(pen, pen.ss())


@diag("TTm")
def _ttm(pen, st):
    return _vmean(pen, pen.TT())


@diag("csm")
def _csm(pen, st):
    return _vrms(pen, pen.cs2())


@diag("ethm")
def _ethm(pen, st):
    """Mean thermal energy density ρ·cv·T."""
    return _vmean(pen, pen.rho() * pen.eos.cv * pen.TT())


@diag("ethtot")
def _ethtot(pen, st):
    """∫ρ·cv·T dV."""
    return _vmean(pen, pen.rho() * pen.eos.cv * pen.TT()) * _boxvol(pen)


# ---- magnetic ---------------------------------------------------------------
@diag("brms")
def _brms(pen, st):
    return _vrms(pen, pen.b2())


@diag("bmax")
def _bmax(pen, st):
    return torch.sqrt(pen.b2().max())


@diag("b2m")
def _b2m(pen, st):
    return _vmean(pen, pen.b2())


@diag("jrms")
def _jrms(pen, st):
    return _vrms(pen, pen.j2())


@diag("jmax")
def _jmax(pen, st):
    return torch.sqrt(pen.j2().max())


@diag("abm")
def _abm(pen, st):
    """Mean magnetic helicity <A·B>."""
    aa, bb = pen.aa(), pen.bb()
    return _vmean(pen, aa[0] * bb[0] + aa[1] * bb[1] + aa[2] * bb[2])


for _i, _c in enumerate("xyz"):
    DIAG_REGISTRY[f"b{_c}2m"] = (
        lambda pen, st, i=_i: _vmean(pen, pen.bb()[i] ** 2))
    DIAG_REGISTRY[f"a{_c}m"] = (
        lambda pen, st, i=_i: _vmean(pen, pen.aa()[i]))


@diag("bm2")
def _bm2(pen, st):
    """max(B²) (magnetic.f90:435)."""
    return pen.b2().max()


def _a2(pen):
    aa = pen.aa()
    return aa[0] ** 2 + aa[1] ** 2 + aa[2] ** 2


@diag("arms")
def _arms(pen, st):
    return _vrms(pen, _a2(pen))


@diag("a2m")
def _a2m(pen, st):
    return _vmean(pen, _a2(pen))


@diag("amax")
def _amax(pen, st):
    """max|A| (magnetic.f90:6044)."""
    return torch.sqrt(_a2(pen).max())


@diag("j2m")
def _j2m(pen, st):
    return _vmean(pen, pen.j2())


@diag("jbm")
def _jbm(pen, st):
    jj, bb = pen.jj(), pen.bb()
    return _vmean(pen, jj[0] * bb[0] + jj[1] * bb[1] + jj[2] * bb[2])


@diag("vA2m")
def _va2m(pen, st):
    return _vmean(pen, pen.b2() * pen.rho1())


@diag("vArms")
def _varms(pen, st):
    return _vrms(pen, pen.va2())


@diag("vAmax")
def _vamax(pen, st):
    return torch.sqrt(pen.va2().max())


def _mean_field(pen, axes, comps):
    """√<Σ B̄_c²> of the components ``comps`` of B averaged over ``axes``
    (magnetic.f90 calc_bmx/calc_bmz: the components transverse to the
    profile's axis carry the dynamo's mean field)."""
    bb = pen.bb()
    return torch.sqrt(torch.mean(sum(bb[c].mean(dim=axes) ** 2
                                     for c in comps)))


@diag("bmx")
def _bmx(pen, st):
    return _mean_field(pen, (1, 2), (1, 2))


@diag("bmy")
def _bmy(pen, st):
    return _mean_field(pen, (0, 2), (0, 2))


@diag("bmz")
def _bmz(pen, st):
    return _mean_field(pen, (0, 1), (0, 1))


@diag("EEM")
def _eem(pen, st):
    """<B²/2> (magnetic.f90:5757)."""
    return 0.5 * _vmean(pen, pen.b2())


@diag("emag")
def _emag(pen, st):
    """∫B²/2 dV, a sum over the grid times the cell volume (a degenerate
    axis weighs 1; magnetic.f90:533)."""
    gs = pen.cfg.grid
    dv = 1.0
    for n, d in ((gs.nx, gs.dx), (gs.ny, gs.dy), (gs.nz, gs.dz)):
        if n > 1:
            dv *= d
    return torch.sum(0.5 * pen.b2()) * dv


def _bbb(pen):
    """B without B_ext (reference p%bbb, magnetic.f90:5784; JAX
    diagnostics.py:954-962)."""
    bb = pen.bb()
    bext = b_ext(pen.cfg)
    if bext is None:
        return bb
    return torch.stack([bb[a] - bext[a] for a in range(3)])


for _i, _c in enumerate("xyz"):
    DIAG_REGISTRY[f"bb{_c}max"] = (
        lambda pen, st, i=_i: _bbb(pen)[i].abs().max())


@diag("uxbm")
def _uxbm(pen, st):
    """<u×B>·B_ext/B_ext² (idiag_uxbm, magnetic.f90:664; JAX
    diagnostics.py:1153-1163), in float32 as there."""
    B0 = np.asarray(pen.cfg.module("magnetic").B_ext, np.float32)
    B02 = max(np.float32((B0 ** 2).sum()), np.float32(1e-30))
    uu, bb = pen.uu(), pen.bb()
    uxb = (uu[1] * bb[2] - uu[2] * bb[1], uu[2] * bb[0] - uu[0] * bb[2],
           uu[0] * bb[1] - uu[1] * bb[0])
    return _vmean(pen, sum(uxb[a] * float(B0[a]) for a in range(3))) \
        / float(B02)


# ---- forcing ----------------------------------------------------------------
def _uf(pen):
    """u·f_cont of the continuous forcing (0 where it is off)."""
    forc = pen.cfg.module("forcing")
    uu = pen.uu()
    if forc is None or not forc.lforcing_cont:
        return torch.zeros_like(uu[0])
    fc = forc.fcont(pen.grid)
    return uu[0] * fc[0] + uu[1] * fc[1] + uu[2] * fc[2]


@diag("ufm")
def _ufm(pen, st):
    """<u·f_cont> (forcing.f90:6075; JAX diagnostics.py:860-863)."""
    return _vmean(pen, _uf(pen))


@diag("rufm")
def _rufm(pen, st):
    """<ρ u·f_cont> (forcing.f90:6065; JAX diagnostics.py:866-869)."""
    return _vmean(pen, pen.rho() * _uf(pen))


# ---- dissipation ------------------------------------------------------------
def _visc_heat(pen):
    """Per-point viscous heating of the configuration's Viscosity as JAX's
    evaluator recomputes it (diagnostics.py:729-744): 2νS² of 'nu-const'
    or 'nu-simplified', (ζ/ρ)(∇·u)² of the bulk viscosity and
    ν_sh·shock·(∇·u)² (the pencil the RHS leaves for Entropy is not
    kept)."""
    visc = pen.cfg.module("viscosity")
    heat = torch.zeros_like(pen.divu())
    if visc is None:
        return heat
    if ({"nu-const", "simplified", "nu-simplified"} & set(visc.ivisc)) \
            and visc.nu > 0.0:
        heat = heat + 2.0 * visc.nu * pen.sij2()
    if visc.selected("rho-nu-const-bulk") and visc.zeta > 0.0:
        heat = heat + (visc.zeta / pen.rho()) * pen.divu() ** 2
    if visc.selected("nu-shock") and visc.nu_shock > 0.0 \
            and "shock" in pen.reg.slots:
        heat = heat + visc.nu_shock * pen.field("shock") * pen.divu() ** 2
    return heat


@diag("epsK")
def _epsk(pen, st):
    """<ρ·visc_heat> (viscosity.f90:2690)."""
    return _vmean(pen, _visc_heat(pen) * pen.rho())


@diag("epsM")
def _epsm(pen, st):
    """<η J²> (magnetic.f90:496)."""
    mag = pen.cfg.module("magnetic")
    return mag.eta * _vmean(pen, pen.j2())


# ---- time-step fractions ----------------------------------------------------
@diag("dtchi")
def _dtchi(pen, st):
    """dt·γ·max(χ·Σ Δ⁻²)/cdtv, the share of the time step the thermal
    diffusivity takes (JAX diagnostics.py:2815-2845, entropy.f90's
    diffus_chi): χ = K/(ρcp) with K = hcond0 or, with 'K-profile', K(z)
    (wherever hcond0 > 0, whatever the flavour), else Kramers' K/(ρcp)
    clipped to [χ_min, χ_max], else χ (χT^c with 'chi-cspeed'), plus
    χ_sh·shock/γ with shock conduction."""
    cfg, e = pen.cfg, pen.eos
    ent = cfg.module("entropy")
    chi = 0.0
    if ent is not None and ent.hcond0 > 0:
        K = (hcond_profile(pen.grid.zg, ent.z1, ent.z2, ent.mpoly0,
                           ent.mpoly1, ent.mpoly2, ent.hcond0, ent.width)
             if "K-profile" in ent.iheatcond else ent.hcond0)
        chi = K * pen.rho1() / e.cp
    elif ent is not None and "kramers" in ent.iheatcond \
            and ent.hcond0_kramers > 0.0:
        n_ = ent.nkramers
        chi = ent.hcond0_kramers * torch.exp(
            -(2.0 * n_ + 1.0) * pen.lnrho() + (6.5 * n_) * pen.lnTT()) / e.cp
        if ent.chimax_kramers > 0.0:
            chi = torch.clamp(chi, ent.chimin_kramers, ent.chimax_kramers)
    elif ent is not None:
        chi = ent.chi
        if {"chi-cspeed", "chi-therm"} & set(ent.iheatcond):
            chi = chi * torch.exp(ent.chi_cspeed * pen.lnTT())
    if ent is not None and ent.chi_shock > 0.0 and "shock" in pen.reg.slots \
            and "shock" in ent.iheatcond:
        chi = chi + ent.chi_shock * pen.field("shock") / e.gamma
    g = pen.grid
    dxyz2 = g.dx1 ** 2 + g.dy1 ** 2 + g.dz1 ** 2
    chi = torch.as_tensor(chi, dtype=pen.f.dtype, device=pen.f.device)
    return st["dt"] * e.gamma * torch.max(chi * dxyz2) / cfg.time.cdtv


# the slot a diagnostic reads beyond uu and lnrho; without it the column is
# refused like an unknown one (the JAX evaluator would fail on the missing
# field)
_NEEDS = dict.fromkeys(
    ("brms", "bmax", "b2m", "bm2", "bx2m", "by2m", "bz2m", "arms", "a2m",
     "axm", "aym", "azm", "amax", "jrms", "jmax", "j2m", "jbm", "abm",
     "vA2m", "vArms", "vAmax", "bmx", "bmy", "bmz", "EEM", "emag", "epsM",
     "bbxmax", "bbymax", "bbzmax", "uxbm"),
    "aa")
_STATE_SCALARS = ("it", "t", "dt")


def make_diagnostics(model, names: Iterable[str], allow_unknown=False):
    """An evaluator state → {name: 0-d tensor on the model's device} for
    the requested columns (``it``, ``t`` and ``dt`` straight from the
    state).  A name that is not ported raises ``KeyError`` unless
    ``allow_unknown``, when it prints as 0, as a label no module claims
    does in the reference."""
    names = list(names)
    reg = model.reg
    unknown = frozenset(
        n for n in names if n not in _STATE_SCALARS and (
            n not in DIAG_REGISTRY or _NEEDS.get(n, "uu") not in reg.slots))
    if unknown and not allow_unknown:
        raise KeyError(f"unknown diagnostics: {sorted(unknown)}")

    def evaluate(state):
        state = model.unpack_state(state)
        fg = model.ghosted(reg.stack(state["fields"]))
        if model._aux_modules:
            fg = model.apply_aux(fg)
        pen = Pencils(fg, model.grid, reg, model.cfg, model.eos,
                      ghosted=True)
        out = {}
        for n in names:
            if n in unknown:
                out[n] = _zero(pen)
            elif n in _STATE_SCALARS:
                out[n] = state[n]
            else:
                out[n] = DIAG_REGISTRY[n](pen, state)
        return out

    return evaluate
