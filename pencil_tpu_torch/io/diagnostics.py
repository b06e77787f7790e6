"""Named scalar diagnostics (counterpart of ``pencil_tpu/io/diagnostics.py``;
reference ``src/diagnostics.f90``: modules save into fname, printed by
``prints`` according to ``print.in``).

Each diagnostic is a named function over the ``Pencils`` container; the
requested set is evaluated in one call on the model's device and comes back
as 0-d tensors, so a caller can stack a row and copy it to the host once.
Ported are the columns of the turbulence runs: the state scalars ``it``,
``t``, ``dt``; hydro ``urms``, ``umax``, ``u2m``; density ``rhom``,
``rhomin``, ``rhomax``; thermodynamics ``ssm``, ``TTm``, ``csm``, ``ethm``;
magnetic ``brms``, ``bmax``, ``b2m``, ``jrms``, ``jmax``, ``abm``; and the
integrals ``ekintot`` and ``ethtot``.  Plain torch: the JAX package computes
them in jnp outside any kernel.  As there, the pencils read a ghost-filled
copy of the state (wraps and BCs, without the shear shift), and a shock slot
is rebuilt from the current fields first.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch

from ..physics.pencils import Pencils


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


# the slot a diagnostic reads beyond uu and lnrho; without it the column is
# refused like an unknown one (the JAX evaluator would fail on the missing
# field)
_NEEDS = {"brms": "aa", "bmax": "aa", "b2m": "aa", "jrms": "aa",
          "jmax": "aa", "abm": "aa"}
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
