"""Boundary conditions on ghost zones (counterpart of
``pencil_tpu/ops/boundary.py``, the codes that act on a z wall).

Each condition is one axis-generic function ``fn(fgc, axis, side, val,
ctx)`` acting IN PLACE on one component's ghosted array (mx, my, mz): it
writes the three ghost planes of one face and, for value-setting codes,
the boundary plane itself.  Ported mnemonics, each the JAX function of
the same name:

  'p', '', 'none'   leave the ghosts as the ghost fill's wrap left them
  's', 'StS'  symmetric about the boundary plane (zero normal derivative)
  'a'    antisymmetric, boundary value pinned to zero
  'a2'   antisymmetric about the boundary value
  'set'  Dirichlet: boundary pinned to val, ghosts antisymmetric about it
  'nil'  symmetric, or untouched where a whole-vector code filled them
  'der'  fixed normal derivative;  '0' zero ghosts;  'cop' copy
  'e1', 'e2'  polynomial extrapolation;  'e3' power law in z
  's0d'  one-sided zero-derivative boundary value, symmetric ghosts
  '1s', 'd1s', 'n1s'  7th-order extrapolation for one-sided derivatives
  'v', 'v3'  vanishing third derivative;  'cdz' geometric decay
  'out', 'ouf'  outflow;  'ubs'  steady outflow, limited inflow
  'ism'  interstellar exponential profile
  'div'  ∇·u = val on the boundary (its tangential part edge-padded)
  'hs'   hydrostatic ghosts from the sound speed at interior (0, 0)
  'pot', 'pwd', 'pfe'  each component filtered by exp(−j|k|Δz)
  'g'    forced boundary value (``Config.force_bound``: '' or 'cT')
  on ss: 'c1' constant flux, 'cT' and 'cT2' constant temperature, 'sT'
         symmetric temperature, 'c2', 'ctz', 'ce', and the flux walls
         'Fgs' (black body) and 'Fct' (constant total flux)
  on ax: 'c1' the whole potential field of A (∇·A = 0; fills ay, az too)

``REFUSED`` names the codes of JAX's registry that are not ported, each
with its reason; ``BC.parse`` raises ``KeyError`` for them, as for an
unknown code.  Cross-field conditions read other components through
``ctx.fg``; ``apply_axis_bcs`` fills the components in bc-tuple order, so
lnrho must come before ss.

A z-wall fill runs on one of three layouts of the x/y extent: the 3-axis
stack (x and y ghosted), a z-only fill of the interior (the kernels wrap x
and y themselves) or a z-only fill of the x/y-ghosted stack.  Every code
acts on each (x, y) column by itself but 'hs' (one interior point),
'c1' on A (whole planes, wrapped in x and y) and 'pot'/'div' (whose ghost
columns are zeros and edge values): these find the layout from the
planes' x extent (``_xy_offset``).  The 3-axis stack's ghost columns are
what JAX's fill gives only in the ghosted layouts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from .stencil import NGHOST, der

# codes of JAX's registry that stay out, with why (BC.parse raises)
REFUSED = {
    "c3": "needs the temperature module",
    "nfr": "spherical r only", "sfr": "spherical r only",
    "spr": "spherical r only", "cpc": "cylindrical R only",
    "pp": "θ axis only (JAX raises on z)",
    "ap": "θ axis only (JAX raises on z)",
    "str": "θ axis only (JAX raises on z)",
    "f": "needs the freeze zones", "fg": "needs the freeze zones",
}
# codes whose ghost columns no x/y wrap reproduces: a walled set with one
# runs its kernels on the x/y-ghosted slabs
COLUMN_CODES = frozenset(("pot", "pwd", "pfe", "div"))
# codes that read more than the boundary plane and 3 interior planes
# ('e2' 5, 's0d' and the one-sided family 7)
DEEP_CODES = frozenset(("e2", "s0d", "1s", "d1s", "n1s"))
# codes that set ss from lnρ and the EOS: on ss only
ENTROPY_CODES = frozenset(("cT", "sT", "c2", "ctz", "cT2", "ce", "Fgs",
                           "Fct"))
# Config.force_bound profiles of 'g' that are ported
FORCE_BOUND = ("", "cT")


@dataclass(frozen=True)
class BC:
    """Per-component boundary condition on one axis: ``low:high``
    mnemonics (config syntax 'a2:cT' splits like the reference
    namelists)."""

    comp: str
    low: str
    high: str
    lval: float = 0.0
    hval: float = 0.0

    @staticmethod
    def parse(comp: str, code: str, lval: float = 0.0,
              hval: float = 0.0) -> "BC":
        lo, hi = code.split(":") if ":" in code else (code, code)
        for mn in (lo, hi):
            if mn in REFUSED:
                raise KeyError(f"BC mnemonic {mn!r} is not ported: "
                               f"{REFUSED[mn]}")
            if mn and mn not in BC_REGISTRY:
                raise KeyError(f"unknown BC mnemonic {mn!r} "
                               f"(known: {sorted(BC_REGISTRY)})")
        return BC(comp, lo, hi, lval, hval)


class BCContext:
    """What a BC formula may read: the stack being filled (``fg``, filled
    in place, so it always holds the components done so far), the
    registry, the grid, its ghosted coordinates (``zgh``: the z vector of
    a cut of the stack, the full grid's at the matching index) and the
    EOS.  A whole-vector code records the other components it filled in
    ``extra``; ``apply_axis_bcs`` moves them to ``filled``, whose own
    'nil' then leaves them alone."""

    def __init__(self, fg, reg, grid, cfg, eos=None, zgh=None):
        self.fg = fg
        self.reg = reg
        self.grid = grid
        self.cfg = cfg
        self.eos = eos
        self.comp = None    # name of the component being filled
        self.coords = None if grid is None else (
            grid.xgh, grid.ygh, grid.zgh if zgh is None else zgh)
        self.extra = {}
        self.filled = set()


def _plane_idx(m: int, side: int, j: int) -> tuple:
    """(ghost_index, mirror_index, boundary_index) for ghost layer j=1..3."""
    g = NGHOST
    if side == 0:
        return g - j, g + j, g
    return m - g - 1 + j, m - g - 1 - j, m - g - 1


def _take(fgc, axis, idx):
    return fgc.narrow(fgc.ndim - 3 + axis, idx, 1)


def _put(fgc, axis, idx, plane):
    _take(fgc, axis, idx).copy_(plane)


def _extent(fgc, axis):
    return fgc.shape[fgc.ndim - 3 + axis]


def _spacing(ctx, axis):
    """Boundary-adjacent grid spacing 1/dz_1[g], rounded in f32 as the JAX
    package rounds it, from the grid's host metric (no device sync)."""
    d1 = (ctx.grid.dx_1, ctx.grid.dy_1, ctx.grid.dz_1)[axis]
    return float(np.float32(1.0) / d1[NGHOST])


def _xy_offset(fgc, ctx):
    """Where the interior starts along x and y in ``fgc``'s layout: 0 in a
    z-only fill of the interior, NGHOST where x and y are ghosted."""
    return 0 if fgc.shape[-3] == ctx.cfg.grid.nx else NGHOST


def _comp(ctx, name):
    return ctx.fg[ctx.reg.comp_names.index(name)]


def bc_sym(fgc, axis, side, val, ctx, sign=1.0, about_value=False):
    m = _extent(fgc, axis)
    for j in (1, 2, 3):
        gi, mi, bi = _plane_idx(m, side, j)
        mirror = _take(fgc, axis, mi)
        if about_value:
            plane = 2.0 * _take(fgc, axis, bi) - mirror
        else:
            plane = sign * mirror
        _put(fgc, axis, gi, plane)
    if sign < 0 and not about_value:
        # 'a': the boundary value itself is pinned to zero (reference
        # bc_sym_z, boundcond.f90:3202)
        _take(fgc, axis, _plane_idx(m, side, 1)[2]).zero_()


def bc_set(fgc, axis, side, val, ctx):
    m = _extent(fgc, axis)
    _take(fgc, axis, _plane_idx(m, side, 1)[2]).fill_(val)
    for j in (1, 2, 3):
        gi, mi, _ = _plane_idx(m, side, j)
        _put(fgc, axis, gi, 2.0 * val - _take(fgc, axis, mi))


def _ramp(sgn, j, d, v):
    """sgn·2j·Δ·v, each product rounded in f32 as JAX's scalars are."""
    return np.float32(np.float32(sgn * 2.0 * j) * np.float32(d)) * v


def bc_der(fgc, axis, side, val, ctx):
    """'der': fixed normal derivative ``val``."""
    m = _extent(fgc, axis)
    d = _spacing(ctx, axis)
    sgn = -1.0 if side == 0 else 1.0
    for j in (1, 2, 3):
        gi, mi, _ = _plane_idx(m, side, j)
        _put(fgc, axis, gi,
             _take(fgc, axis, mi) + float(_ramp(sgn, j, d, np.float32(val))))


def _lnrho_comp(ctx):
    if "lnrho" not in ctx.reg.slots:
        raise NotImplementedError(
            f"pencil_tpu_torch: BC on {ctx.comp!r} needs an lnrho slot")
    return ctx.fg[ctx.reg.slice("lnrho").start]


def bc_ss_temp(fgc, axis, side, val, ctx):
    """'cT': constant temperature.  With cs² = cs₀²·exp(γs/cp +
    (γ−1)(lnρ−lnρ₀)), T = const holds γs/cp + (γ−1)lnρ at its boundary
    value.  ``val`` > 0 is the target cs²; 0 pins T to its instantaneous
    boundary-plane value."""
    eos = ctx.eos
    lnrho = _lnrho_comp(ctx)
    m = _extent(fgc, axis)
    bi = _plane_idx(m, side, 1)[2]
    g1 = (eos.gamma - 1.0) / eos.gamma
    if val > 0.0:
        lncs2 = math.log(val / eos.cs20) / eos.gamma

        def ss_of(lnr):
            return eos.cp * (lncs2 - g1 * (lnr - eos.lnrho0))

        _put(fgc, axis, bi, ss_of(_take(lnrho, axis, bi)))
        for j in (1, 2, 3):
            gi = _plane_idx(m, side, j)[0]
            _put(fgc, axis, gi, ss_of(_take(lnrho, axis, gi)))
    else:
        ss_b = _take(fgc, axis, bi)
        lnrho_b = _take(lnrho, axis, bi)
        for j in (1, 2, 3):
            gi = _plane_idx(m, side, j)[0]
            dlnrho = _take(lnrho, axis, gi) - lnrho_b
            _put(fgc, axis, gi, ss_b - eos.cp * g1 * dlnrho)


def bc_ss_flux(fgc, axis, side, val, ctx):
    """'c1': constant heat flux F = −K∇T through the boundary.  ``val`` =
    F/K; ghost entropy chosen so the lnT slope across the boundary is
    −(F/K)/T_boundary."""
    eos = ctx.eos
    lnrho = _lnrho_comp(ctx)
    m = _extent(fgc, axis)
    bi = _plane_idx(m, side, 1)[2]
    d = _spacing(ctx, axis)
    g_cp = eos.gamma / eos.cp
    gm1 = eos.gamma - 1.0
    ss_b = _take(fgc, axis, bi)
    lnrho_b = _take(lnrho, axis, bi)
    lnTT_b = eos.lnTT0 + g_cp * ss_b + gm1 * (lnrho_b - eos.lnrho0)
    dlnTT = -val / torch.exp(lnTT_b)
    sgn = -1.0 if side == 0 else 1.0
    for j in (1, 2, 3):
        gi, mi, _ = _plane_idx(m, side, j)
        ss_m = _take(fgc, axis, mi)
        lnrho_m = _take(lnrho, axis, mi)
        lnTT_m = eos.lnTT0 + g_cp * ss_m + gm1 * (lnrho_m - eos.lnrho0)
        lnTT_g = lnTT_m + sgn * 2.0 * j * d * dlnTT
        lnrho_g = _take(lnrho, axis, gi)
        _put(fgc, axis, gi, eos.cp / eos.gamma * (
            (lnTT_g - eos.lnTT0) - gm1 * (lnrho_g - eos.lnrho0)))


def bc_zero(fgc, axis, side, val, ctx):
    """'0': zero ghosts, the boundary value free."""
    m = _extent(fgc, axis)
    for j in (1, 2, 3):
        _take(fgc, axis, _plane_idx(m, side, j)[0]).zero_()


def bc_copy(fgc, axis, side, val, ctx):
    """'cop': the boundary plane copied into every ghost plane."""
    m = _extent(fgc, axis)
    bnd = _take(fgc, axis, _plane_idx(m, side, 1)[2])
    for j in (1, 2, 3):
        _put(fgc, axis, _plane_idx(m, side, j)[0], bnd)


# polynomial extrapolation weights (reference bcx_extrap_2_1/2_2): rows are
# ghost layers 1..3, columns the boundary and the next interior planes
_E1 = ((9 / 4, -3 / 4, -5 / 4, 3 / 4),
       (81 / 20, -43 / 20, -57 / 20, 39 / 20),
       (127 / 20, -81 / 20, -99 / 20, 73 / 20))
_E2 = ((9 / 5, 0.0, -4 / 5, -3 / 5, 3 / 5),
       (3.0, -2 / 5, -9 / 5, -6 / 5, 7 / 5),
       (157 / 35, -33 / 35, -108 / 35, -68 / 35, 87 / 35))


def _bc_extrap_poly(fgc, axis, side, coefs):
    m = _extent(fgc, axis)
    inward = 1 if side == 0 else -1
    bi = _plane_idx(m, side, 1)[2]
    for j, row in enumerate(coefs, start=1):
        acc = None
        for k, c in enumerate(row):
            if c == 0.0:
                continue
            term = c * _take(fgc, axis, bi + inward * k)
            acc = term if acc is None else acc + term
        _put(fgc, axis, _plane_idx(m, side, j)[0], acc)


def bc_extrap_e1(fgc, axis, side, val, ctx):
    """'e1': quadratic extrapolation (reference bcx_extrap_2_1)."""
    _bc_extrap_poly(fgc, axis, side, _E1)


def bc_extrap_e2(fgc, axis, side, val, ctx):
    """'e2': extrapolation from 5 planes (reference bcx_extrap_2_2)."""
    _bc_extrap_poly(fgc, axis, side, _E2)


def _log_abs(x):
    return np.log(np.abs(np.float32(x)))


def bc_extrap_e3(fgc, axis, side, val, ctx):
    """'e3': power-law (log-log) extrapolation, f ∝ coordᵖ (reference
    bcx_extrap_2_3): needs a positive f and nonzero coordinates."""
    m = _extent(fgc, axis)
    cv = ctx.coords[axis]
    for j in (1, 2, 3):
        gi, mi, bi = _plane_idx(m, side, j)
        yb = torch.log(torch.clamp_min(_take(fgc, axis, bi), 1e-30))
        ym = torch.log(torch.clamp_min(_take(fgc, axis, mi), 1e-30))
        xb, xm, xg = _log_abs(cv[bi]), _log_abs(cv[mi]), _log_abs(cv[gi])
        slope = (yb - ym) / float(xb - xm)
        _put(fgc, axis, gi, torch.exp(yb + slope * float(xg - xb)))


_ONESIDED = (360.0, -450.0, 400.0, -225.0, 72.0, -10.0)


def bc_symset0der(fgc, axis, side, val, ctx):
    """'s0d': the boundary value from the 6th-order one-sided
    zero-derivative formula, then symmetric ghosts (reference
    bc_symset0der_x)."""
    m = _extent(fgc, axis)
    inward = 1 if side == 0 else -1
    bi = _plane_idx(m, side, 1)[2]
    acc = None
    for k, c in enumerate(_ONESIDED, start=1):
        term = c * _take(fgc, axis, bi + inward * k)
        acc = term if acc is None else acc + term
    _put(fgc, axis, bi, acc / 147.0)
    bc_sym(fgc, axis, side, val, ctx, sign=1.0)


def bc_van(fgc, axis, side, val, ctx):
    """'v': a linear ramp of the boundary value to zero across the
    ghosts (reference bc_van_x)."""
    m = _extent(fgc, axis)
    bnd = _take(fgc, axis, _plane_idx(m, side, 1)[2])
    for j in (1, 2, 3):
        _put(fgc, axis, _plane_idx(m, side, j)[0],
             bnd * ((NGHOST + 1.0 - j) / (NGHOST + 1)))


def bc_van3rd(fgc, axis, side, val, ctx):
    """'v3': vanishing third derivative by one-sided quadratic
    extrapolation (reference bc_van3rd_y)."""
    m = _extent(fgc, axis)
    d = _spacing(ctx, axis)
    inward = 1 if side == 0 else -1
    bi = _plane_idx(m, side, 1)[2]
    f0 = _take(fgc, axis, bi)
    f1 = _take(fgc, axis, bi + inward)
    f2 = _take(fgc, axis, bi + 2 * inward)
    c1 = -(3.0 * f0 - 4.0 * f1 + f2) / float(np.float32(2.0 * d))
    c2 = -(-f0 + 2.0 * f1 - f2) / float(np.float32(np.float32(2.0 * d) * d))
    for j in (1, 2, 3):
        jd = float(np.float32(j * d))
        _put(fgc, axis, _plane_idx(m, side, j)[0],
             f0 - c1 * jd + c2 * float(np.float32(jd) ** 2))


def bc_outflow(fgc, axis, side, val, ctx, force_ghost=False):
    """'ouf' (and 'out' with ``force_ghost``): outflow but no inflow —
    symmetric where the boundary velocity points out, antisymmetric (the
    boundary pinned to 0) where it points in (reference bc_outflow_z);
    'out' also clips an inward-pointing ghost."""
    m = _extent(fgc, axis)
    bi = _plane_idx(m, side, 1)[2]
    bnd = _take(fgc, axis, bi)
    outflowing = (bnd < 0.0) if side == 0 else (bnd > 0.0)
    _put(fgc, axis, bi, torch.where(outflowing, bnd, 0.0))
    for j in (1, 2, 3):
        gi, mi, _ = _plane_idx(m, side, j)
        mirror = _take(fgc, axis, mi)
        ghost = torch.where(outflowing, mirror, -mirror)
        if force_ghost:
            ghost = torch.clamp_max(ghost, 0.0) if side == 0 \
                else torch.clamp_min(ghost, 0.0)
        _put(fgc, axis, gi, ghost)


def bc_steady(fgc, axis, side, val, ctx):
    """'ubs': the boundary value copied where it flows out, the inflow
    gradient limited where it flows in (reference bc_steady_z)."""
    m = _extent(fgc, axis)
    inward = 1 if side == 0 else -1
    bi = _plane_idx(m, side, 1)[2]
    f0 = _take(fgc, axis, bi)
    f1 = _take(fgc, axis, bi + inward)
    outflowing = (f0 <= 0.0) if side == 0 else (f0 >= 0.0)
    steep = (f0 > f1) if side == 0 else (f0 < f1)
    g1 = torch.where(outflowing, f0,
                     torch.where(steep, 0.5 * (f0 + f1), 2.0 * f0 - f1))
    prev2, prev1 = f0, g1
    _put(fgc, axis, bi - inward, g1)
    for j in (2, 3):
        gj = torch.where(outflowing, f0, 2.0 * prev1 - prev2)
        _put(fgc, axis, _plane_idx(m, side, j)[0], gj)
        prev2, prev1 = prev1, gj


def bc_ss_stemp(fgc, axis, side, val, ctx):
    """'sT': symmetric temperature — ghost entropy offsets the density
    ghosts so that T is mirrored (reference bc_ss_stemp_x)."""
    eos = ctx.eos
    lnrho = _lnrho_comp(ctx)
    m = _extent(fgc, axis)
    cpmcv = eos.cp - eos.cp / eos.gamma
    for j in (1, 2, 3):
        gi, mi, _ = _plane_idx(m, side, j)
        dlnrho = _take(lnrho, axis, mi) - _take(lnrho, axis, gi)
        _put(fgc, axis, gi, _take(fgc, axis, mi) + cpmcv * dlnrho)


def bc_ss_temp_old(fgc, axis, side, val, ctx):
    """'c2': constant temperature through the boundary plane (reference
    bc_ss_temp_old): ``val`` the target cs², 0 the plane's own; ghosts
    antisymmetric about the boundary value."""
    eos = ctx.eos
    lnrho = _lnrho_comp(ctx)
    m = _extent(fgc, axis)
    bi = _plane_idx(m, side, 1)[2]
    g1 = (eos.gamma - 1.0) / eos.gamma
    if val > 0.0:
        lncs2 = float(np.log(np.float32(val / eos.cs20)))
        _put(fgc, axis, bi, eos.cp * (
            lncs2 / eos.gamma - g1 * (_take(lnrho, axis, bi) - eos.lnrho0)))
    ss_b = _take(fgc, axis, bi)
    for j in (1, 2, 3):
        gi, mi, _ = _plane_idx(m, side, j)
        _put(fgc, axis, gi, 2.0 * ss_b - _take(fgc, axis, mi))


def bc_ism(fgc, axis, side, val, ctx):
    """'ism': the interstellar runs' exponential ghost profile (reference
    bc_ism, boundcond.f90:8590-8676); ``val`` the scale (0 → 0.9).  On ss
    the local temperature held plus cv·ln(Δz·h + 1); on lnρ a decay by
    Δz·h at the bottom and Δz/h at the top (the reference's asymmetry)."""
    scale = val if val > 0 else 0.9
    m = _extent(fgc, axis)
    cvv = ctx.coords[axis]
    bi = _plane_idx(m, side, 1)[2]
    bnd = _take(fgc, axis, bi)
    if ctx.comp == "ss":
        eos = ctx.eos
        lnrho = _lnrho_comp(ctx)
        cvs = eos.cp / eos.gamma
        lnrho_b = _take(lnrho, axis, bi)
        for j in (1, 2, 3):
            gi = _plane_idx(m, side, j)[0]
            dist = np.abs(np.float32(cvv[gi]) - np.float32(cvv[bi]))
            soft = float(np.log(np.float32(dist * np.float32(scale)) + 1))
            _put(fgc, axis, gi, bnd + (eos.cp - cvs) * (
                lnrho_b - _take(lnrho, axis, gi)) + cvs * soft)
    else:
        fac = np.float32(scale if side == 0 else 1.0 / scale)
        for j in (1, 2, 3):
            gi = _plane_idx(m, side, j)[0]
            dist = np.abs(np.float32(cvv[gi]) - np.float32(cvv[bi]))
            _put(fgc, axis, gi, bnd - float(dist * fac))


def bc_cdz(fgc, axis, side, val, ctx):
    """'cdz': geometric decay by (1 − 1.11Δz) per ghost layer (reference
    bc_cdz)."""
    m = _extent(fgc, axis)
    fac = float(np.float32(1.0)
                - np.float32(1.11) * np.float32(_spacing(ctx, axis)))
    prev = _take(fgc, axis, _plane_idx(m, side, 1)[2])
    for j in (1, 2, 3):
        prev = prev * fac
        _put(fgc, axis, _plane_idx(m, side, j)[0], prev)


def bc_ctz(fgc, axis, side, val, ctx):
    """'ctz': entropy ghosts that keep T constant along the (already
    filled) density ghosts (reference bc_ctz)."""
    eos = ctx.eos
    lnrho = _lnrho_comp(ctx)
    m = _extent(fgc, axis)
    cpmcv = eos.cp - eos.cp / eos.gamma
    bi = _plane_idx(m, side, 1)[2]
    prev_ss = _take(fgc, axis, bi)
    prev_lnr = _take(lnrho, axis, bi)
    for j in (1, 2, 3):
        gi = _plane_idx(m, side, j)[0]
        lnr = _take(lnrho, axis, gi)
        prev_ss = prev_ss + cpmcv * (prev_lnr - lnr)
        prev_lnr = lnr
        _put(fgc, axis, gi, prev_ss)


def _edge_index(n, o, device):
    """Indices that pad an axis of ``n`` interior points by ``o`` on each
    side with its edge values."""
    return torch.clamp(torch.arange(n + 2 * o, device=device) - o, 0, n - 1)


def _wrap_index(n, o, device):
    """Indices that pad an axis of ``n`` points by ``o`` on each side
    periodically."""
    return torch.remainder(torch.arange(n + 2 * o, device=device) - o, n)


def bc_set_div(fgc, axis, side, val, ctx):
    """'div': ∇·u = ``val`` on the boundary by the normal-derivative ghosts
    of u_normal (reference bc_set_div_z).  The tangential divergence of
    the boundary plane, from its x/y ghosts (or its wrap in a z-only
    layout), is edge-padded over the ghost columns, as JAX pads it."""
    m = _extent(fgc, axis)
    bi = _plane_idx(m, side, 1)[2]
    o = _xy_offset(fgc, ctx)
    gs = ctx.cfg.grid
    n = (gs.nx, gs.ny, gs.nz)
    taxes = tuple(a for a in range(3) if a != axis)
    tang = None
    for a2 in taxes:
        plane = _take(_comp(ctx, ("ux", "uy", "uz")[a2]), axis, bi)
        dd = der(plane, a2, wrap=not o)
        if o:
            other = next(a for a in taxes if a != a2)
            dd = dd.narrow(other, o, n[other])
        d1 = (ctx.grid.dx_1, ctx.grid.dy_1, ctx.grid.dz_1)[a2]
        shp = [1, 1, 1]
        shp[a2] = -1
        dd = dd * torch.tensor(d1[NGHOST:-NGHOST], dtype=dd.dtype,
                               device=dd.device).reshape(shp)
        tang = dd if tang is None else tang + dd
    if o:
        for a in taxes:
            tang = tang.index_select(a, _edge_index(n[a], o, tang.device))
    target = val - tang
    d = _spacing(ctx, axis)
    sgn = -1.0 if side == 0 else 1.0
    for j in (1, 2, 3):
        gi, mi, _ = _plane_idx(m, side, j)
        _put(fgc, axis, gi, _take(fgc, axis, mi)
             + float(_ramp(sgn, j, d, np.float32(1.0))) * target)


def bc_onesided(fgc, axis, side, val, ctx, n2nd=False, dirichlet=False,
                neumann=False):
    """'1s'/'d1s'/'n1s': ghosts for one-sided 1st/2nd derivatives
    (reference set_ghosts_for_onesided_ders, deriv.f90:5777-5840): the
    7th-order extrapolation ghost(k) = 7(f₁−f₆) − 21(f₂−f₅) + 35(f₃−f₄)
    + f₇, filled outward; 'd1s' pins the boundary to ``val`` first and
    'n1s' sets it from the one-sided 6th-order Neumann formula; both fill
    the two inner ghosts only."""
    m = _extent(fgc, axis)
    g = NGHOST
    sgn = 1 if side == 0 else -1
    bi = g if side == 0 else m - g - 1
    if dirichlet:
        _take(fgc, axis, bi).fill_(val)
    if neumann:
        d = _spacing(ctx, axis)
        s = sum(c * _take(fgc, axis, bi + sgn * (k + 1))
                for k, c in enumerate(_ONESIDED))
        _put(fgc, axis, bi, (float(np.float32(
            np.float32(-sgn * val * 60.0) * np.float32(d))) + s) / 147.0)
    nset = g - 1 if n2nd else g
    idxs = (range(g - 1, g - 1 - nset, -1) if side == 0
            else range(m - g, m - g + nset))
    for k in idxs:
        v = (7.0 * (_take(fgc, axis, k + sgn) - _take(fgc, axis, k + 6 * sgn))
             - 21.0 * (_take(fgc, axis, k + 2 * sgn)
                       - _take(fgc, axis, k + 5 * sgn))
             + 35.0 * (_take(fgc, axis, k + 3 * sgn)
                       - _take(fgc, axis, k + 4 * sgn))
             + _take(fgc, axis, k + 7 * sgn))
        _put(fgc, axis, k, v)


def bc_ss_temp2(fgc, axis, side, val, ctx):
    """'cT2': constant temperature keeping lnρ (bc_ss_temp2_z): ss on the
    boundary and the ghosts from the local density, so that cs² = ``val``
    (0 → cs20) there."""
    eos = ctx.eos
    lnrho = _lnrho_comp(ctx)
    m = _extent(fgc, axis)
    cs2 = val if val > 0.0 else eos.cs20
    cv = eos.cp / eos.gamma
    tmp = float(np.float32(cv) * np.log(np.float32(cs2 / eos.cs20)))
    bi = _plane_idx(m, side, 1)[2]
    for j in (0, 1, 2, 3):
        gi = bi if j == 0 else _plane_idx(m, side, j)[0]
        _put(fgc, axis, gi,
             tmp - (eos.cp - cv) * (_take(lnrho, axis, gi) - eos.lnrho0))


def bc_ss_energy(fgc, axis, side, val, ctx):
    """'ce': the ghosts' cs² pinned to the boundary's given the local
    density (bc_ss_energy)."""
    eos = ctx.eos
    lnrho = _lnrho_comp(ctx)
    m = _extent(fgc, axis)
    g1 = eos.gamma - 1.0
    cv = eos.cp / eos.gamma
    lncs20 = float(np.log(np.float32(eos.cs20)))
    bi = _plane_idx(m, side, 1)[2]
    lncs2_b = (lncs20 + g1 * _take(lnrho, axis, bi)
               + (1.0 / cv) * _take(fgc, axis, bi))
    for j in (1, 2, 3):
        gi = _plane_idx(m, side, j)[0]
        _put(fgc, axis, gi,
             cv * (-g1 * _take(lnrho, axis, gi) - lncs20 + lncs2_b))


def bc_hydrostatic(fgc, axis, side, val, ctx):
    """'hs': hydrostatic ghosts (bc_lnrho_hds_z_iso): constant slopes
    dlnρ/dz = γg_z/cs², ds/dz = −(γ−1)g_z/cs² from the sound speed at one
    point, the boundary plane's interior (0, 0), in whichever layout the
    fill runs; needs Gravity with a constant gravz."""
    eos = ctx.eos
    grav = ctx.cfg.module("gravity") if ctx.cfg is not None else None
    if grav is None or getattr(grav, "gravz", 0.0) == 0.0:
        raise NotImplementedError("'hs' needs gravity with constant gravz")
    gz = float(grav.gravz)
    lnrho = _lnrho_comp(ctx)
    m = _extent(fgc, axis)
    bi = _plane_idx(m, side, 1)[2]
    o = _xy_offset(fgc, ctx)
    corner = [o, o, o]
    corner[axis] = bi
    corner = tuple(corner)
    lnr0 = lnrho[corner]
    ss0 = _comp(ctx, "ss")[corner] if "ss" in ctx.reg.slots else 0.0
    g1 = eos.gamma - 1.0
    cs2_pt = eos.cs20 * torch.exp(eos.gamma * ss0 / eos.cp
                                  + g1 * (lnr0 - eos.lnrho0))
    if ctx.comp == "lnrho":
        slope = eos.gamma * gz / cs2_pt
    elif ctx.comp == "ss":
        slope = -g1 * gz / cs2_pt
    else:
        raise NotImplementedError(f"'hs' on component {ctx.comp!r}")
    d = _spacing(ctx, axis)
    sgn = 1.0 if side == 0 else -1.0
    for j in (1, 2, 3):
        gi, mi, _ = _plane_idx(m, side, j)
        _put(fgc, axis, gi, _take(fgc, axis, mi)
             - float(_ramp(sgn, j, d, np.float32(1.0))) * slope)


def _entropy_field(ctx, name, default):
    ent = ctx.cfg.module("entropy") if ctx.cfg is not None else None
    return getattr(ent, name, default) if ent is not None else default


def _boundary_thermo(ctx, axis, side):
    """(ρ, T, dlnρ/dn, boundary index) on the boundary plane, the flux
    walls' common part (reference bc_ss_flux_turb_x): dlnρ/dn the
    centred 6th-order derivative across the plane, from lnρ's ghosts,
    filled before ss's."""
    eos = ctx.eos
    lnrho_f = _lnrho_comp(ctx)
    ss_f = _comp(ctx, "ss")
    m = _extent(ss_f, axis)
    bi = _plane_idx(m, side, 1)[2]
    lnrho_b = _take(lnrho_f, axis, bi)
    rho = torch.exp(lnrho_b)
    cs2 = eos.cs20 * torch.exp((eos.gamma - 1.0) * (lnrho_b - eos.lnrho0)
                               + (eos.gamma / eos.cp) * _take(ss_f, axis, bi))
    TT = cs2 / ((eos.gamma - 1.0) * eos.cp)
    d1 = 1.0 / _spacing(ctx, axis)
    c = (45.0 / 60.0, -9.0 / 60.0, 1.0 / 60.0)
    dldn = sum(c[j - 1] * (_take(lnrho_f, axis, bi + j)
                           - _take(lnrho_f, axis, bi - j))
               for j in (1, 2, 3)) * d1
    return rho, TT, dldn, bi


def _kramers_k(ctx, TT, rho):
    """Kramers' K₀T^6.5n/ρ^2n where hcond0_kramers > 0, else None."""
    K0 = _entropy_field(ctx, "hcond0_kramers", 0.0)
    if K0 <= 0.0:
        return None
    nk = _entropy_field(ctx, "nkramers", 1.0)
    return K0 * TT ** (6.5 * nk) * rho ** (-2.0 * nk)


def bc_ss_flux_turb(fgc, axis, side, val, ctx):
    """'Fgs': black-body wall −χ_t ρT ds/dn − K dT/dn = σ_SBt·T⁴
    (bc_ss_flux_turb_x): ds/dn = −(σ_SBt T³ + K(γ−1) dlnρ/dn)/(χ_t,prof
    χ_t ρ + K/cv), with Kramers' K added to hcondbot/hcondtop."""
    eos = ctx.eos
    rho, TT, dldn, bi = _boundary_thermo(ctx, axis, side)
    sig = _entropy_field(ctx, "sigmaSBt", 0.0)
    chi_t = _entropy_field(ctx, "chi_t", 0.0)
    chit_prof = _entropy_field(ctx, "chit_prof1" if side == 0
                               else "chit_prof2", 1.0)
    hcond = _entropy_field(ctx, "hcondbot" if side == 0 else "hcondtop",
                           0.0)
    kr = _kramers_k(ctx, TT, rho)
    if kr is not None:
        hcond = hcond + kr
    cv = eos.cp / eos.gamma
    dsdn = -(sig * TT ** 3 + hcond * (eos.gamma - 1.0) * dldn) \
        / (chit_prof * chi_t * rho + hcond / cv + 1e-30)
    m = _extent(fgc, axis)
    d = _spacing(ctx, axis)
    sgn = -1.0 if side == 0 else 1.0
    for j in (1, 2, 3):
        gi, mi, _ = _plane_idx(m, side, j)
        _put(fgc, axis, gi, _take(fgc, axis, mi)
             + float(_ramp(sgn, j, d, np.float32(1.0))) * dsdn)


def bc_ss_flux_condturb(fgc, axis, side, val, ctx):
    """'Fct': constant total flux F = −K dT/dn − χ_t ρT ds/dn
    (bc_ss_flux_condturb_x): f(g_j) = f(m_j) + K(γ−1)/(K/cv + χ_tρ)·Δlnρ_j
    + 2jΔ·dsdn with dsdn = (F/T)/(χ_t,prof χ_t ρ + K/cv); Kramers' K in
    place of hcondbot/hcondtop."""
    eos = ctx.eos
    rho, TT, dldn, bi = _boundary_thermo(ctx, axis, side)
    chi_t = _entropy_field(ctx, "chi_t", 0.0)
    chit_prof = _entropy_field(ctx, "chit_prof1" if side == 0
                               else "chit_prof2", 1.0)
    F = _entropy_field(ctx, "Fbot" if side == 0 else "Ftop", 0.0)
    cv1 = eos.gamma / eos.cp
    K = _kramers_k(ctx, TT, rho)
    if K is None:
        K = _entropy_field(ctx, "hcondbot" if side == 0 else "hcondtop",
                           0.0)
    dsdn = (F / torch.clamp_min(TT, 1e-30)) \
        / (chit_prof * chi_t * rho + K * cv1 + 1e-30)
    lnrho_f = _lnrho_comp(ctx)
    m = _extent(fgc, axis)
    d = _spacing(ctx, axis)
    sgn = -1.0 if side == 0 else 1.0
    fac = K * (eos.gamma - 1.0) / (K * cv1 + chit_prof * chi_t * rho + 1e-30)
    for j in (1, 2, 3):
        gi, mi, _ = _plane_idx(m, side, j)
        dlnrho_j = (_take(lnrho_f, axis, mi) - _take(lnrho_f, axis, gi)) \
            * (-sgn)
        _put(fgc, axis, gi, _take(fgc, axis, mi) + fac * dlnrho_j
             - float(_ramp(sgn, j, d, np.float32(1.0))) * dsdn)


def bc_force(fgc, axis, side, val, ctx):
    """'g': a forced boundary value from ``Config.force_bound`` (bc_force_z,
    boundcond.f90:1576): 'cT' holds ln(cs20/(γ−1)), '' the current value;
    ghosts antisymmetric about it.  'uxy_sin-cos' is refused (JAX raises
    on a z wall)."""
    fb = ctx.cfg.force_bound
    prof = fb[side] if len(fb) > side else ""
    if prof not in FORCE_BOUND:
        raise NotImplementedError(
            f"pencil_tpu_torch: force_bound {prof!r} (ported: "
            f"{list(FORCE_BOUND)})")
    m = _extent(fgc, axis)
    bi = _plane_idx(m, side, 1)[2]
    if prof == "cT":
        eos = ctx.eos
        _take(fgc, axis, bi).fill_(float(np.log(np.float32(
            eos.cs20 / (eos.gamma - 1.0)))))
    plane = _take(fgc, axis, bi)
    for j in (1, 2, 3):
        gi, mi, _ = _plane_idx(m, side, j)
        _put(fgc, axis, gi, 2.0 * plane - _take(fgc, axis, mi))


def _wavenumbers(gs, device):
    """2π·fftfreq along x and y of the periodic grid ``gs``, float32, as
    JAX's :968 'pot' forms them."""
    return tuple(2.0 * math.pi * torch.fft.fftfreq(
        n, d=L / max(n, 1), device=device) for n, L in ((gs.nx, gs.Lx),
                                                        (gs.ny, gs.Ly)))


def bc_aa_pot(fgc, axis, side, val, ctx):
    """'pot', 'pwd', 'pfe': a vacuum field beyond the z wall, component by
    component (JAX boundary.py:968, bc_aa_pot2 of boundcond.f90:6278): ghost
    plane j is the boundary plane's interior filtered by exp(−j|k_h|Δz) in
    horizontal Fourier space; in an x/y-ghosted layout the ghost planes'
    x/y ghost columns are zeros, as JAX writes them."""
    if axis != 2:
        raise NotImplementedError("'pot' BC is a z-boundary condition")
    m = _extent(fgc, axis)
    bi = _plane_idx(m, side, 1)[2]
    gs = ctx.cfg.grid
    o = _xy_offset(fgc, ctx)
    nx, ny = gs.nx, gs.ny
    pin = fgc[o:o + nx, o:o + ny, bi]
    d = _spacing(ctx, axis)
    kx, ky = _wavenumbers(gs, fgc.device)
    kap = torch.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
    ft = torch.fft.fft2(pin)
    for j in (1, 2, 3):
        gi = _plane_idx(m, side, j)[0]
        gplane = torch.fft.ifft2(ft * torch.exp(-j * kap * d)).real
        if o:
            fgc[..., gi].zero_()
        fgc[o:o + nx, o:o + ny, gi] = gplane


def _aa_pot_planes(F1, kk, dz, nplanes):
    """The real planes ifft2(e^{−|k|·iΔz}·F1), i = 0..nplanes−1 outward of
    the boundary."""
    return [torch.fft.ifft2(torch.exp(-kk * (i * dz)) * F1).real
            for i in range(nplanes)]


def bc_aa_pot_field(fgc, axis, side, val, ctx):
    """'c1' on the vector potential: the potential field beyond the z wall
    (JAX boundary.py:1094, reference bc_aa_pot, boundcond.f90:7919-7982).
    Fired on ax, it fills the whole vector: A_x and A_y obey ∂A/∂z = ∓|k|A
    per horizontal mode (boundary value (4f₂−f₃)/(3+2Δz|k|), ghosts
    e^{−|k|δz}), A_z follows from ∇·A = 0 of the new boundary planes; the
    boundary plane and the ghosts of all three, wrapped in x and y where
    the layout has their ghost columns.  On ay and az a no-op."""
    if axis != 2:
        raise NotImplementedError("bc_aa_pot: z boundaries only")
    if ctx.comp != "ax":
        return
    spec = ctx.cfg.grid
    g = NGHOST
    mz = fgc.shape[-1]
    nx, ny = spec.nx, spec.ny
    o = _xy_offset(fgc, ctx)
    dev = fgc.device
    dz = _spacing(ctx, axis)
    kx = (2.0 * math.pi / spec.Lx) * torch.fft.fftfreq(nx, 1.0 / nx,
                                                       device=dev)
    ky = (2.0 * math.pi / spec.Ly) * torch.fft.fftfreq(ny, 1.0 / ny,
                                                       device=dev)
    kkx, kky = kx[:, None], ky[None, :]
    kk = torch.sqrt(kkx ** 2 + kky ** 2)
    nb = g if side == 0 else mz - g - 1
    ix, iy = _wrap_index(nx, o, dev), _wrap_index(ny, o, dev)

    def intplane(arr, zidx):
        return arr[o:o + nx, o:o + ny, zidx]

    def write_planes(arr, planes):
        for i, pl in enumerate(planes):
            zidx = nb - i if side == 0 else nb + i
            arr[..., zidx] = pl[ix][:, iy] if o else pl

    s_in = 1 if side == 0 else -1
    iay, iaz = (ctx.reg.comp_names.index(c) for c in ("ay", "az"))
    ay, az = ctx.fg[iay], ctx.fg[iaz]
    for arr in (fgc, ay):
        F2 = torch.fft.fft2(intplane(arr, nb + s_in))
        F3 = torch.fft.fft2(intplane(arr, nb + 2 * s_in))
        F1 = (4.0 * F2 - F3) / (3.0 + 2.0 * dz * kk)
        write_planes(arr, _aa_pot_planes(F1, kk, dz, g + 1))
    F2 = torch.fft.fft2(intplane(fgc, nb))
    F3 = torch.fft.fft2(intplane(ay, nb))
    kk1 = kk.clone()
    kk1[0, 0] = 1.0
    fac = 1.0 / kk1
    fac[0, 0] = 0.0
    F1 = 1j * fac * (kkx * F2 + kky * F3)
    sgn = -1.0 if side == 0 else 1.0
    write_planes(az, [sgn * p for p in _aa_pot_planes(F1, kk, dz, g + 1)])
    ctx.extra[iay] = ay
    ctx.extra[iaz] = az


def _on(comps, fn, code):
    """``fn`` on the components ``comps`` only; any other raises, naming
    the code ('cT'/'c1' on TT or lnTT need the temperature module)."""
    def bc(fgc, axis, side, val, ctx):
        if ctx.comp not in comps:
            raise NotImplementedError(
                f"pencil_tpu_torch: BC {code!r} on {ctx.comp!r} (ported on "
                f"{sorted(comps)})")
        return fn(fgc, axis, side, val, ctx)
    return bc


_c1_ss = _on(("ss",), bc_ss_flux, "c1")


def _c1(fgc, axis, side, val, ctx):
    """'c1' is overloaded as in the reference (boundcond.f90:1411-1416):
    the potential field on the vector potential, the heat flux on ss."""
    if ctx.comp in ("ax", "ay", "az"):
        return bc_aa_pot_field(fgc, axis, side, val, ctx)
    return _c1_ss(fgc, axis, side, val, ctx)


def _nil(fgc, axis, side, val, ctx):
    """'nil': the reference leaves the stored ghosts untouched; here they
    are refilled each time, so symmetric, but untouched where a
    whole-vector code ('c1' on ax) filled them this axis."""
    if ctx.reg.comp_names.index(ctx.comp) not in ctx.filled:
        bc_sym(fgc, axis, side, val, ctx)


def _keep(f, a, s, v, c):
    return None


BC_REGISTRY: Dict[str, Callable] = {
    "p": _keep,
    "": _keep,
    "none": _keep,
    "s": lambda f, a, s, v, c: bc_sym(f, a, s, v, c, sign=1.0),
    "StS": lambda f, a, s, v, c: bc_sym(f, a, s, v, c, sign=1.0),
    "a": lambda f, a, s, v, c: bc_sym(f, a, s, v, c, sign=-1.0),
    "a2": lambda f, a, s, v, c: bc_sym(f, a, s, v, c, about_value=True),
    "set": bc_set,
    "nil": _nil,
    "der": bc_der,
    "0": bc_zero,
    "cop": bc_copy,
    "e1": bc_extrap_e1,
    "e2": bc_extrap_e2,
    "e3": bc_extrap_e3,
    "s0d": bc_symset0der,
    "1s": bc_onesided,
    "d1s": lambda f, a, s, v, c: bc_onesided(f, a, s, v, c, n2nd=True,
                                             dirichlet=True),
    "n1s": lambda f, a, s, v, c: bc_onesided(f, a, s, v, c, n2nd=True,
                                             neumann=True),
    "v": bc_van,
    "v3": bc_van3rd,
    "out": lambda f, a, s, v, c: bc_outflow(f, a, s, v, c, force_ghost=True),
    "ouf": bc_outflow,
    "ubs": bc_steady,
    "ism": bc_ism,
    "cdz": bc_cdz,
    "div": bc_set_div,
    "hs": bc_hydrostatic,
    "g": bc_force,
    # JAX's registry binds 'pot', 'pwd' and 'pfe' to its first bc_aa_pot
    # (boundary.py:968), the per-component filter; 'c1' on A reaches the
    # second (:1094), the whole potential field
    "pot": bc_aa_pot,
    "pwd": bc_aa_pot,
    "pfe": bc_aa_pot,
    "c1": _c1,
    "cT": _on(("ss",), bc_ss_temp, "cT"),
    "sT": bc_ss_stemp,
    "c2": bc_ss_temp_old,
    "ctz": bc_ctz,
    "cT2": bc_ss_temp2,
    "ce": bc_ss_energy,
    "Fgs": bc_ss_flux_turb,
    "Fct": bc_ss_flux_condturb,
}


def apply_axis_bcs(fg, axis, bcs, reg, grid, cfg, eos=None, zgh=None):
    """Apply the physical BCs of one non-periodic axis on both faces, in
    place, component by component in ``bcs`` order (JAX
    boundary.py:1166-1207 on one device); ``zgh``: the z coordinates of
    ``fg``'s planes where it is a cut of the full stack."""
    ctx = BCContext(fg, reg, grid, cfg, eos, zgh)
    for bc in bcs:
        ctx.comp = bc.comp
        fgc = fg[reg.comp_names.index(bc.comp)]
        for side, code, val in ((0, bc.low, bc.lval), (1, bc.high, bc.hval)):
            if code in ("p", "", "none"):
                continue
            fn = BC_REGISTRY.get(code)
            if fn is None:
                raise KeyError(f"unknown BC mnemonic {code!r} (axis {axis})")
            fn(fgc, axis, side, val, ctx)
            ctx.filled.update(ctx.extra)
            ctx.extra = {}
    return fg
