"""6th-order central finite differences (counterpart of
``pencil_tpu/ops/stencil.py`` for nghost = 3).

Two modes per axis, as in the JAX package.  Wrapped (``wrap=True``, the
default): the axis is periodic over its full extent, a shift is a
``torch.roll`` and the result keeps the input's shape.  Ghosted
(``wrap=False``): the axis carries 3 ghost cells on each side, a shift is
a slice, and the result has the interior extent along that axis; ``i()``
crops the ghosts of the other axes.  Operators take a tensor whose
trailing three axes are (x, y, z).  Weights come from the
Taylor/Vandermonde system exactly as in the JAX package.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

NGHOST = 3

# bidiagonal mixed-derivative coefficients per diagonal offset o = 1, 2, 3
# (reference derij_main, deriv.f90:1376-1420)
BIDIAG = (270.0 / 720.0, -27.0 / 720.0, 2.0 / 720.0)
# the four diagonal taps of each offset: (s1, s2, sign) in units of o
BIDIAG_TAPS = ((1, 1, 1.0), (-1, 1, -1.0), (-1, -1, 1.0), (1, -1, -1.0))


@functools.lru_cache(maxsize=None)
def fd_weights(offsets: tuple, deriv: int) -> tuple:
    """Finite-difference weights for d^k/dx^k on unit-spaced ``offsets``
    (method of undetermined coefficients; equivalent to Fornberg 1988)."""
    n = len(offsets)
    if deriv >= n:
        raise ValueError("stencil too small for derivative order")
    A = np.vander(np.asarray(offsets, dtype=np.float64), n, increasing=True).T
    b = np.zeros(n)
    b[deriv] = math.factorial(deriv)
    w = np.linalg.solve(A, b)
    w[np.abs(w) < 1e-13] = 0.0
    return tuple(float(v) for v in w)


def paired_weights(deriv: int) -> tuple:
    """The weights w_o, o = 1..3, of the paired form below."""
    offs = tuple(range(-NGHOST, NGHOST + 1))
    w = fd_weights(offs, deriv)
    return tuple(w[NGHOST + o] for o in range(1, NGHOST + 1))


def _shift(f, ax, o, wrap=True):
    """f[i + o] along array axis ``ax``: a roll (periodic) or the slice of
    the interior extent (ghosted)."""
    if not wrap:
        return f.narrow(ax, NGHOST + o, f.shape[ax] - 2 * NGHOST)
    return f if o == 0 else torch.roll(f, -o, dims=ax)


def i(arr, axes=(0, 1, 2)):
    """Crop the ghost zones of the given spatial axes (JAX ``stencil.i``)."""
    for a in axes:
        ax = arr.ndim - 3 + a
        arr = arr.narrow(ax, NGHOST, arr.shape[ax] - 2 * NGHOST)
    return arr


def _paired(f, axis, deriv, wrap=True):
    """Central stencil in PAIRED form, so constants cancel exactly in f32
    (reference deriv.f90:89-171; JAX stencil.py:145-184):

      odd  derivative:  Σ_{o>0} w_o·(f₊ₒ − f₋ₒ)
      even derivative:  Σ_{o>0} w_o·(f₊ₒ + f₋ₒ − 2·f₀)
    """
    ax = f.ndim - 3 + axis
    f0 = _shift(f, ax, 0, wrap)
    out = None
    for o, w in zip(range(1, NGHOST + 1), paired_weights(deriv)):
        if deriv % 2:
            term = w * (_shift(f, ax, o, wrap) - _shift(f, ax, -o, wrap))
        else:
            term = w * (_shift(f, ax, o, wrap) + _shift(f, ax, -o, wrap)
                        - 2.0 * f0)
        out = term if out is None else out + term
    return out


def der(f, axis, inv_d=None, wrap=True):
    """1st derivative, 6th-order central (reference der_main, deriv.f90:89)."""
    out = _paired(f, axis, 1, wrap)
    return out if inv_d is None else out * inv_d


def der2(f, axis, inv_d=None, wrap=True):
    """2nd derivative, 6th-order central (reference der2_main, deriv.f90:474)."""
    out = _paired(f, axis, 2, wrap)
    return out if inv_d is None else out * inv_d ** 2


def der5(f, axis, inv_d=None, wrap=True):
    """5th derivative on the 7-point stencil, 2nd order (JAX
    stencil.py:235), the building block of the 'hyper3-nu-const' and
    'hyper3-rho-nu-const-symm' viscosities."""
    out = _paired(f, axis, 5, wrap)
    return out if inv_d is None else out * inv_d ** 5


def der6(f, axis, wrap=True):
    """Unscaled 6th difference on the 7-point stencil (JAX stencil.py:239
    with inv_d=None), the building block of the del6 hyperdiffusion."""
    return _paired(f, axis, 6, wrap)


def derij_bidiag(f, ax1, ax2, inv1=None, inv2=None, wrap=True, wrap2=None):
    """Mixed second derivative ∂²/∂x_i∂x_j, 12-point bidiagonal scheme —
    the reference default (derij_main, deriv.f90:1376-1420): 6th order
    from the three neighbours on each half-diagonal, in one pass.  With
    ``wrap=False`` ax1 is ghosted and reduced to the interior; ax2 follows
    ``wrap2``, which defaults to ``wrap`` (the JAX package's wrap_z mode
    rolls z while slicing x or y)."""
    if ax1 == ax2:
        raise ValueError("use der2 for repeated axes")
    wrap2 = wrap if wrap2 is None else wrap2
    a1 = f.ndim - 3 + ax1
    a2 = f.ndim - 3 + ax2
    out = None
    for o, c in zip(range(1, NGHOST + 1), BIDIAG):
        for s1, s2, sgn in BIDIAG_TAPS:
            if wrap and wrap2:
                sl = torch.roll(f, (-s1 * o, -s2 * o), dims=(a1, a2))
            else:
                sl = _shift(_shift(f, a1, s1 * o, wrap), a2, s2 * o, wrap2)
            t = (sgn * c) * sl
            out = t if out is None else out + t
    if inv1 is not None:
        out = out * inv1
    if inv2 is not None:
        out = out * inv2
    return out
