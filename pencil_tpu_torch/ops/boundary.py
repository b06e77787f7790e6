"""Boundary conditions on ghost zones (counterpart of the subset of
``pencil_tpu/ops/boundary.py`` that stratified convection reads).

Each condition is one axis-generic function ``fn(fgc, axis, side, val,
ctx)`` acting IN PLACE on one component's ghosted array (mx, my, mz): it
writes the three ghost planes of one face and, for value-setting codes,
the boundary plane itself.  Ported mnemonics:

  'p'    periodic (realized by the ghost fill's wrap)
  's'    symmetric about the boundary plane (zero normal derivative)
  'a'    antisymmetric, boundary value pinned to zero
  'a2'   antisymmetric about the boundary value
  'set'  Dirichlet: boundary pinned to val, ghosts antisymmetric about it
  'c1'   constant heat flux on ss (reference bc_ss_flux)
  'cT'   constant temperature on ss (reference bc_ss_temp)

Every other mnemonic raises ``KeyError``, as the JAX parser does for an
unknown one.  Cross-field conditions (c1, cT) read lnρ's ghosts through
``ctx.fg``; ``apply_axis_bcs`` fills the components in bc-tuple order, so
lnrho must come before ss.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from .stencil import NGHOST


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
            if mn and mn not in BC_REGISTRY:
                raise KeyError(f"unknown BC mnemonic {mn!r} "
                               f"(known: {sorted(BC_REGISTRY)})")
        return BC(comp, lo, hi, lval, hval)


class BCContext:
    """What a BC formula may read: the stack being filled (``fg``, filled
    in place, so it always holds the components done so far), the
    registry, the grid and the EOS."""

    def __init__(self, fg, reg, grid, cfg, eos=None):
        self.fg = fg
        self.reg = reg
        self.grid = grid
        self.cfg = cfg
        self.eos = eos
        self.comp = None    # name of the component being filled


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


def _lnrho_comp(ctx):
    if "lnrho" not in ctx.reg.slots:
        raise NotImplementedError(
            "pencil_tpu_torch: 'cT'/'c1' need an lnrho slot")
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


def _entropy_only(fn, code):
    def bc(fgc, axis, side, val, ctx):
        if ctx.comp != "ss":
            raise NotImplementedError(
                f"pencil_tpu_torch: BC {code!r} on {ctx.comp!r} "
                "(ported on ss only)")
        return fn(fgc, axis, side, val, ctx)
    return bc


BC_REGISTRY: Dict[str, Callable] = {
    "p": lambda f, a, s, v, c: None,
    "s": lambda f, a, s, v, c: bc_sym(f, a, s, v, c, sign=1.0),
    "a": lambda f, a, s, v, c: bc_sym(f, a, s, v, c, sign=-1.0),
    "a2": lambda f, a, s, v, c: bc_sym(f, a, s, v, c, about_value=True),
    "set": bc_set,
    "c1": _entropy_only(bc_ss_flux, "c1"),
    "cT": _entropy_only(bc_ss_temp, "cT"),
}


def apply_axis_bcs(fg, axis, bcs, reg, grid, cfg, eos=None):
    """Apply the physical BCs of one non-periodic axis on both faces, in
    place, component by component in ``bcs`` order (JAX
    boundary.py:1166-1207 on one device)."""
    ctx = BCContext(fg, reg, grid, cfg, eos)
    for bc in bcs:
        ctx.comp = bc.comp
        fgc = fg[reg.comp_names.index(bc.comp)]
        for side, code, val in ((0, bc.low, bc.lval), (1, bc.high, bc.hval)):
            if code in ("p", ""):
                continue
            fn = BC_REGISTRY.get(code)
            if fn is None:
                raise KeyError(f"unknown BC mnemonic {code!r} (axis {axis})")
            fn(fgc, axis, side, val, ctx)
    return fg
