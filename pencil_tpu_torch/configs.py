"""Named configurations of the port, shared by its tests and
``chip_smoke.py``.  Each builder takes the package whose classes it uses
(``pencil_tpu_torch`` or ``pencil_tpu``), so the tests build the same
configuration in both.
"""
from __future__ import annotations

import sys


def conv_slab(n, fused=True, pkg=None):
    """Stratified convection in the style of the Pencil Code's conv-slab
    sample: a stable layer (mpoly1 = 3) from z0 to z1, an unstable one
    (mpoly0 = 1) from z1 to z2 and an isothermal one above, under constant
    gravity, with K-const conduction, a heating layer at the bottom, a
    cooling layer at the top and viscous heating; unforced; 5 fields (uu,
    lnrho, ss).  x and y are periodic; z has physical boundaries.  ``n``
    is an int (a cube) or (nx, ny, nz).  The values are this
    configuration's own, not the sample's start.in/run.in.

    The bottom c1 flux follows the run-directory loader's rule
    (pencil_tpu/compat/rundir.py:2400-2406):
    −γ·gravz/((mpoly1+1)(γ−1)cp) = 0.625; the top cT holds cs² = cs2cool.
    The bcz order matters: lnrho before ss, whose c1/cT read lnρ's ghosts.
    """
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    gamma, cp, gravz, mpoly1, cs2cool = 5.0 / 3.0, 1.0, -1.0, 3.0, 1.0
    lval = -gamma * gravz / ((mpoly1 + 1.0) * (gamma - 1.0) * cp)
    bcz = (pkg.BC.parse("ux", "s"), pkg.BC.parse("uy", "s"),
           pkg.BC.parse("uz", "a"), pkg.BC.parse("lnrho", "a2"),
           pkg.BC.parse("ss", "c1:cT", lval=lval, hval=cs2cool))
    return pkg.Config(
        grid=pkg.GridSpec(nx=nx, ny=ny, nz=nz, x0=-0.5, y0=-0.5, z0=-0.68,
                          Lx=1.0, Ly=1.0, Lz=1.0,
                          periodic=(True, True, False)),
        time=pkg.TimeSpec(itorder=3), fused=fused, bcz=bcz,
        modules=(pkg.EosIdealGas(gamma=gamma, cs0=1.0, cp=cp),
                 pkg.Density(init="piecew-poly"),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-3),
                 pkg.Gravity(gravz_profile="const", gravz=gravz),
                 pkg.Viscosity(ivisc=("nu-const",), nu=4e-3),
                 pkg.Entropy(init="piecew-poly", z1=-0.5, z2=0.0, mpoly0=1.0,
                             mpoly1=mpoly1, mpoly2=0.0, isothtop=1,
                             iheatcond=("K-const",), hcond0=8e-3,
                             luminosity=5e-3, wheat=0.1, cool=15.0,
                             wcool=0.2, cs2cool=cs2cool)))


def shear_box(n, fused=True, pkg=None):
    """A sheared, rotating MHD box with shock viscosity and
    hyper-diffusion, the accretion-disk set-up of shearing-box MRI users:
    a unit cube centred on the origin, fully periodic with shear-periodic
    x faces (Keplerian shear q = 3/2, Ω = 1, Coriolis on), isothermal gas
    (cs = 1), ν = η = 5e-4, shock viscosity ν_sh = 1, and del6
    hyper-diffusion of u, A and lnρ; unforced; 8 slots (uu, lnrho, aa and
    the shock profile).  ``n`` is an int (a cube) or (nx, ny, nz).  The
    values are this configuration's own, not a reference sample's.

    The hyper-diffusivity h3 = 5e-3·(1/n)⁵ keeps the del6 CFL rate
    h3·dxyz6/cdtv3 (cdtv3 = 0.01) at about half the advective rate at
    every n, so the term shows at 16³ and stays stable at 256³.
    """
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    h3 = 5e-3 * (1.0 / nx) ** 5
    return pkg.Config(
        grid=pkg.GridSpec(nx=nx, ny=ny, nz=nz, x0=-0.5, y0=-0.5, z0=-0.5,
                          Lx=1.0, Ly=1.0, Lz=1.0),
        time=pkg.TimeSpec(itorder=3), fused=fused,
        modules=(pkg.EosIdealGas(gamma=1.0, cs0=1.0),
                 pkg.Density(init="gaussian-noise", ampl=1e-2,
                             diffrho_hyper3=h3),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-2, Omega=1.0),
                 pkg.Shear(Omega=1.0, qshear=1.5),
                 pkg.Viscosity(ivisc=("nu-const", "nu-shock",
                                      "hyper3-simplified"),
                               nu=5e-4, nu_shock=1.0, nu_hyper3=h3),
                 pkg.Magnetic(init="gaussian-noise", ampl=1e-4, eta=5e-4,
                              eta_hyper3=h3),
                 pkg.Shock()))


def shock_box(n, fused=True, pkg=None):
    """Supersonic forced MHD turbulence with shock viscosity, the Pencil
    Code's shock-capturing set-up (Haugen, Brandenburg & Mee 2004, MNRAS
    353, 947): the default 2π cube, fully periodic, isothermal gas
    (cs = 1), ν = η = 1e-3, shock viscosity ν_sh = 1, non-helical forcing
    (relhel = 0) of amplitude 0.2 at kf = 3; 8 slots (uu, lnrho, aa and the
    shock profile).  ``n`` is an int (a cube) or (nx, ny, nz).  The values
    are this configuration's own, not a reference sample's."""
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    return pkg.Config(
        grid=pkg.GridSpec(nx=nx, ny=ny, nz=nz),
        time=pkg.TimeSpec(itorder=3), fused=fused,
        modules=(pkg.EosIdealGas(gamma=1.0, cs0=1.0),
                 pkg.Density(),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-2),
                 pkg.Viscosity(ivisc=("nu-const", "nu-shock"), nu=1e-3,
                               nu_shock=1.0),
                 pkg.Magnetic(init="gaussian-noise", ampl=1e-4, eta=1e-3),
                 pkg.Shock(),
                 pkg.Forcing(force=0.2, kf=3.0, relhel=0.0)))


def forced_hydro(n, fused=True, pkg=None, Omega=0.0):
    """Forced isothermal hydro turbulence, the flagship without Magnetic
    (BASELINE config 2): the default 2π cube, fully periodic, isothermal
    gas (cs = 1), ν = 5e-3, helical forcing of amplitude 0.07 at kf = 3;
    4 fields (uu, lnrho).  ``Omega`` > 0 adds the Coriolis force of a
    rotation about z.  ``n`` is an int (a cube) or (nx, ny, nz).  The
    values are this configuration's own, not a reference sample's."""
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    return pkg.Config(
        grid=pkg.GridSpec(nx=nx, ny=ny, nz=nz),
        time=pkg.TimeSpec(itorder=3), fused=fused,
        modules=(pkg.EosIdealGas(gamma=1.0, cs0=1.0),
                 pkg.Density(lupw_lnrho=False),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-3, Omega=Omega),
                 pkg.Viscosity(ivisc=("nu-const",), nu=5e-3),
                 pkg.Forcing(force=0.07, kf=3.0)))


def flagship(n, fused=True, pkg=None, itorder=3, dt=0.0):
    """Forced isothermal MHD turbulence, the package's headline workload
    (the configuration ``bench.py`` times): the default 2π cube, fully
    periodic, isothermal gas (cs = 1), ν = η = 5e-3, gaussian-noise u and A,
    helical forcing of amplitude 0.07 at kf = 3; 7 fields (uu, lnrho, aa).
    ``itorder`` is the 2N-RK order; ``dt`` > 0 fixes the time step.  ``n``
    is an int (a cube) or (nx, ny, nz).  The values are this repository's
    own, not a reference sample's."""
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    return pkg.Config(
        grid=pkg.GridSpec(nx=nx, ny=ny, nz=nz),
        time=pkg.TimeSpec(itorder=itorder, dt=dt), fused=fused,
        modules=(pkg.EosIdealGas(gamma=1.0, cs0=1.0),
                 pkg.Density(lupw_lnrho=False),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-3),
                 pkg.Viscosity(ivisc=("nu-const",), nu=5e-3),
                 pkg.Magnetic(init="gaussian-noise", ampl=1e-4, eta=5e-3),
                 pkg.Forcing(force=0.07, kf=3.0)))


def forced_entropy(n, magnetic=True, fused=True, pkg=None, Omega=0.0):
    """Non-isothermal forced turbulence, the flagship with an entropy
    field: the default 2π cube, fully periodic, an ideal gas with γ = 5/3
    (cs0 = 1, cp = 1), ν = 5e-3, thermal diffusion 'chi-const' with
    χ = 5e-3, viscous heating, helical forcing of amplitude 0.07 at
    kf = 3; with ``magnetic`` also A with η = 5e-3, the Lorentz force and
    Ohmic heating.  8 fields (uu, lnrho, ss, aa), or 5 (uu, lnrho, ss)
    without Magnetic.  ``Omega`` > 0 adds the Coriolis force of a rotation
    about z.  ``n`` is an int (a cube) or (nx, ny, nz).  The values are
    this repository's own (the flagship's, plus χ = ν), not a reference
    sample's."""
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    mag = (pkg.Magnetic(init="gaussian-noise", ampl=1e-4, eta=5e-3),) \
        if magnetic else ()
    return pkg.Config(
        grid=pkg.GridSpec(nx=nx, ny=ny, nz=nz),
        time=pkg.TimeSpec(itorder=3), fused=fused,
        modules=(pkg.EosIdealGas(gamma=5.0 / 3.0, cs0=1.0, cp=1.0),
                 pkg.Density(),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-3, Omega=Omega),
                 pkg.Viscosity(ivisc=("nu-const",), nu=5e-3),
                 pkg.Entropy(iheatcond=("chi-const",), chi=5e-3),
                 *mag,
                 pkg.Forcing(force=0.07, kf=3.0)))
