"""Lazy derived-field container (counterpart of the subset of
``pencil_tpu/physics/pencils.py`` that the flagship, stratified convection
and the shearing box read).

The whole block is "the pencil": derived fields are memoized on first
access, and each quantity has the interior shape (nx, ny, nz).  Three
input modes: periodic (``ghosted=False``), where ``f`` is the raw stacked
state (nc, nx, ny, nz) and every axis wraps; ghosted, where ``f`` is the
stack ghosted on all three axes (nc, nx+2g, ny+2g, nz+2g) by
``fill_ghosts``, derivatives slice it and ``field`` crops it (the JAX
package's default mode); and ``wrap_z``, where x and y are ghosted and z
wraps (nc, nx+2g, ny+2g, nz) — the JAX package's zroll tiles
(pencils.py:40-65).  This is the plain PyTorch evaluation of the RHS that
the fused kernels are held to.
"""
from __future__ import annotations

import numpy as np
import torch

from ..integrate.timestep import pow6
from ..ops import stencil as st


def _memo(fn):
    name = fn.__name__

    def wrapper(self, *args):
        key = (name, args) if args else name
        if key not in self._cache:
            self._cache[key] = fn(self, *args)
        return self._cache[key]

    return wrapper


def b_ext(cfg):
    """Magnetic's imposed field B_ext as three float32-exact floats, or
    None where it is 0 (or there is no Magnetic)."""
    mag = cfg.module("magnetic") if cfg is not None else None
    if mag is None or not any(b != 0.0 for b in mag.B_ext):
        return None
    return tuple(float(np.float32(b)) for b in mag.B_ext)


def _cross(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


class Pencils:
    def __init__(self, f, grid, reg, cfg, eos=None, ghosted=False,
                 wrap_z=False):
        self.f = f              # periodic, fully ghosted or x/y-ghosted
        self.grid = grid
        self.reg = reg
        self.cfg = cfg
        self.eos = eos
        # the axes that carry ghost zones; the others wrap
        self._gh_axes = (0, 1, 2) if ghosted else ((0, 1) if wrap_z else ())
        self._cache = {}

    def _inv(self, axis):
        return self.grid.dline_1()[axis]

    def dline_1(self):
        return self.grid.dline_1()

    def _wr(self, axis):
        return axis not in self._gh_axes

    def _slab(self, name):
        return self.f[self.reg.slice(name)]

    def _crop(self, arr, axes):
        """Interior along those of ``axes`` that carry ghosts."""
        return st.i(arr, tuple(a for a in axes if a in self._gh_axes))

    # ---- derivatives -----------------------------------------------------
    @_memo
    def _gh_only(self, name, axis):
        """Slab ghosted only along ``axis`` (the other axes cropped)."""
        return self._crop(self._slab(name),
                          tuple(a for a in range(3) if a != axis))

    @_memo
    def d(self, name, axis):
        """∂(field)/∂x_axis, shape (ncomp, nx, ny, nz)."""
        return st.der(self._gh_only(name, axis), axis,
                      wrap=self._wr(axis)) * self._inv(axis)

    @_memo
    def d2(self, name, axis):
        return st.der2(self._gh_only(name, axis), axis,
                       wrap=self._wr(axis)) * self._inv(axis) ** 2

    @_memo
    def d6_raw(self, name, axis):
        """Plain 6th difference Σc_k f_{i+k}, not scaled by Δ⁻⁶ (JAX
        pencils.py:229)."""
        return st.der6(self._gh_only(name, axis), axis, wrap=self._wr(axis))

    @_memo
    def d5_raw(self, name, axis):
        """Plain 5th difference, not scaled by Δ⁻⁵ (JAX pencils.py:236),
        in every input mode (JAX's slices, so its wrapped tiles fail)."""
        return st.der5(self._gh_only(name, axis), axis, wrap=self._wr(axis))

    @_memo
    def del6v_scaled(self, name):
        """Σ_a ∂⁶f/∂x_a⁶ with the Δ⁻⁶ scaling (hyper3 'simplified'; JAX
        pencils.py:302-305)."""
        return sum(self.d6_raw(name, a) * pow6(self._inv(a))
                   for a in range(3))

    @_memo
    def del6s_scaled(self, name):
        return sum(self.d6_raw(name, a)[0] * pow6(self._inv(a))
                   for a in range(3))

    def _bidiag(self, sl, a, b):
        rest = tuple({0, 1, 2} - {a, b})
        out = st.derij_bidiag(self._crop(sl, rest), a, b, wrap=self._wr(a),
                              wrap2=self._wr(b))
        return out * self._inv(a) * self._inv(b)

    @_memo
    def dij(self, name, ax1, ax2):
        """Mixed second derivative, bidiagonal scheme (the reference and
        JAX default, PC_DERIJ='bidiag')."""
        if ax1 == ax2:
            return self.d2(name, ax1)
        return self._bidiag(self._slab(name), min(ax1, ax2), max(ax1, ax2))

    @_memo
    def dij_comp(self, name, comp, ax1, ax2):
        """Mixed second derivative of ONE component (the graddiv pattern)."""
        if ax1 == ax2:
            return self.d2(name, ax1)[comp]
        return self._bidiag(self._slab(name)[comp:comp + 1],
                            min(ax1, ax2), max(ax1, ax2))[0]

    @_memo
    def grad(self, name):
        """(3, nx, ny, nz) gradient of a scalar field."""
        return torch.stack([self.d(name, a)[0] for a in range(3)])

    @_memo
    def del2s(self, name):
        """Laplacian of a scalar field."""
        return sum(self.d2(name, a)[0] for a in range(3))

    @_memo
    def del2v(self, name):
        """Laplacian of a vector field: (3, nx, ny, nz)."""
        return sum(self.d2(name, a) for a in range(3))

    def _graddiv(self, name):
        """∇(∇·v): the diagonal reuses the del2 second derivatives."""
        out = []
        for a in range(3):
            acc = self.d2(name, a)[a]
            for j in range(3):
                if j != a:
                    acc = acc + self.dij_comp(name, j, a, j)
            out.append(acc)
        return torch.stack(out)

    @_memo
    def field(self, name):
        arr = self._crop(self._slab(name), (0, 1, 2))
        return arr[0] if self.reg.slots[name].ncomp == 1 else arr

    def ugrad(self, name, upwind=False):
        """u·∇f for a scalar field, with ``upwind`` less the 5th-order
        upwinding Σ_a |u_a|·δ⁶_a f/(60Δ_a) (reference der6_upwind, the
        lupw_* flags; JAX pencils.py:341-353)."""
        uu = self.uu_advec()
        out = sum(uu[a] * self.d(name, a)[0] for a in range(3))
        if upwind:
            out = out - self.upwind(name, uu)[0]
        return out

    def upwind(self, name, uu):
        """Σ_a |u_a|·δ⁶_a f/(60Δ_a) of each component of ``name``, the
        plain 6th difference ``d6_raw`` in JAX's product order:
        (ncomp, nx, ny, nz)."""
        return sum(uu[a].abs() * self.d6_raw(name, a) * self._inv(a) / 60.0
                   for a in range(3))

    # ---- hydro -----------------------------------------------------------
    @_memo
    def uu(self):
        return self.field("uu")

    @_memo
    def uu_advec(self):
        """The advecting velocity (== uu: FARGO is not ported)."""
        return self.uu()

    @_memo
    def u2(self):
        uu = self.uu()
        return uu[0] ** 2 + uu[1] ** 2 + uu[2] ** 2

    @_memo
    def uij(self):
        """u_{i;j} = ∂u_i/∂x_j: (3, 3, nx, ny, nz)."""
        return torch.stack([self.d("uu", j) for j in range(3)], dim=1)

    @_memo
    def divu(self):
        uij = self.uij()
        return uij[0, 0] + uij[1, 1] + uij[2, 2]

    @_memo
    def grad5divu(self):
        """(grad5divu)_i = Σ_j ∂⁵/∂x_i⁵ ∂u_j/∂x_j, the symmetric
        hyper-viscosity's cross term (JAX pencils.py:312-333): i = j the
        6th difference, i ≠ j ∂⁵_i then ∂_j of u_j, ghosted (or wrapped)
        along those two axes."""
        uu = self._slab("uu")
        out = []
        for a in range(3):
            acc = self.d6_raw("uu", a)[a] * pow6(self._inv(a))
            for j in range(3):
                if j == a:
                    continue
                rest = tuple({0, 1, 2} - {a, j})
                t = st.der5(self._crop(uu[j:j + 1], rest), a,
                            wrap=self._wr(a))
                t = st.der(t, j, wrap=self._wr(j))
                acc = acc + t[0] * self._inv(a) ** 5 * self._inv(j)
            out.append(acc)
        return torch.stack(out)

    @_memo
    def oo(self):
        """Vorticity ∇×u (JAX pencils.py:403, the Cartesian branch)."""
        uij = self.uij()
        return torch.stack([
            uij[2, 1] - uij[1, 2],
            uij[0, 2] - uij[2, 0],
            uij[1, 0] - uij[0, 1],
        ])

    @_memo
    def sij(self):
        """Traceless rate-of-strain S_ij: (3, 3, nx, ny, nz)."""
        uij = self.uij()
        div3 = self.divu() / 3.0
        rows = []
        for a in range(3):
            row = []
            for b in range(3):
                s = 0.5 * (uij[a, b] + uij[b, a])
                if a == b:
                    s = s - div3
                row.append(s)
            rows.append(torch.stack(row))
        return torch.stack(rows)

    @_memo
    def sij2(self):
        s = self.sij()
        return torch.sum(s * s, dim=(0, 1))

    @_memo
    def ugu(self):
        """(u·∇)u: (3, nx, ny, nz)."""
        uij = self.uij()
        uadv = self.uu_advec()
        return torch.stack([
            sum(uadv[j] * uij[a, j] for j in range(3)) for a in range(3)
        ])

    @_memo
    def del2u(self):
        return self.del2v("uu")

    @_memo
    def graddivu(self):
        return self._graddiv("uu")

    # ---- density and pressure ---------------------------------------------
    @_memo
    def lnrho(self):
        return self.field("lnrho")

    @_memo
    def glnrho(self):
        return self.grad("lnrho")

    @_memo
    def del2lnrho(self):
        return self.del2s("lnrho")

    @_memo
    def rho(self):
        return torch.exp(self.lnrho())

    @_memo
    def rho1(self):
        return torch.exp(-self.lnrho())

    @_memo
    def cs2(self):
        return self.eos.cs2(self)

    @_memo
    def fpres(self):
        """−∇p/ρ for the ideal gas: −cs²(∇lnρ + ∇s/cp), or −cs²∇lnρ
        without an entropy slot."""
        gl = self.glnrho()
        if "ss" in self.reg.slots:
            gl = gl + self.gss() / self.eos.cp
        return -self.cs2() * gl

    # ---- entropy and temperature ------------------------------------------
    @_memo
    def ss(self):
        return self.field("ss")

    @_memo
    def gss(self):
        return self.grad("ss")

    @_memo
    def del2ss(self):
        return self.del2s("ss")

    @_memo
    def lnTT(self):
        return self.eos.lnTT(self)

    @_memo
    def TT(self):
        return torch.exp(self.lnTT())

    @_memo
    def TT1(self):
        return torch.exp(-self.lnTT())

    @_memo
    def glnTT(self):
        """∇lnT = (γ−1)∇lnρ + γ∇s/cp (ideal gas)."""
        e = self.eos
        out = (e.gamma - 1.0) * self.glnrho()
        if "ss" in self.reg.slots:
            out = out + (e.gamma / e.cp) * self.gss()
        return out

    @_memo
    def del2lnTT(self):
        e = self.eos
        out = (e.gamma - 1.0) * self.del2lnrho()
        if "ss" in self.reg.slots:
            out = out + (e.gamma / e.cp) * self.del2ss()
        return out

    # ---- magnetic --------------------------------------------------------
    @_memo
    def aa(self):
        return self.field("aa")

    @_memo
    def aij(self):
        return torch.stack([self.d("aa", j) for j in range(3)], dim=1)

    @_memo
    def bb(self):
        """B = ∇×A, plus the imposed uniform field B_ext where it is not 0
        (JAX pencils.py:682-697: the curl first, then one add in f32)."""
        aij = self.aij()
        curl = (aij[2, 1] - aij[1, 2], aij[0, 2] - aij[2, 0],
                aij[1, 0] - aij[0, 1])
        bext = b_ext(self.cfg)
        if bext is not None:
            curl = tuple(c + b for c, b in zip(curl, bext))
        return torch.stack(curl)

    @_memo
    def b2(self):
        bb = self.bb()
        return bb[0] ** 2 + bb[1] ** 2 + bb[2] ** 2

    @_memo
    def del2a(self):
        return self.del2v("aa")

    @_memo
    def graddiva(self):
        return self._graddiv("aa")

    @_memo
    def jj(self):
        """J = ∇×B = ∇(∇·A) − ∇²A (µ₀ = 1)."""
        return self.graddiva() - self.del2a()

    @_memo
    def j2(self):
        jj = self.jj()
        return jj[0] ** 2 + jj[1] ** 2 + jj[2] ** 2

    @_memo
    def uxb(self):
        return _cross(self.uu(), self.bb())

    @_memo
    def jxb(self):
        return _cross(self.jj(), self.bb())

    @_memo
    def jxbr(self):
        return self.jxb() * self.rho1()

    @_memo
    def va2(self):
        """Alfvén speed squared B²/(µ₀ρ), µ₀ = 1."""
        return self.b2() * self.rho1()
