"""Run directories in the shapes of two of the Pencil Code's samples,
written for ``python -m pencil_tpu_torch start|run|export <rundir>``:

* ``helical_mhdturb``: forced helical MHD turbulence as in the sample
  helical-MHDturb (the nr_f90 random stream, gaussian-noise u and A,
  helical forcing drawn from a k.dat shell, |k| within 0.5 of 3), with
  the values of ``configs.flagship``, optionally in an imposed field or
  driven by continuous forcing;
* ``conv_slab``: stratified convection as in the sample conv-slab (the
  default min_std stream, gaussian-noise u, piecewise polytropic layers,
  K-const conduction, heating and cooling layers, z walls), with the
  values of ``configs.conv_slab``.

Each writes start.in, run.in, src/cparam.local, src/Makefile.local (and
print.in, k.dat) under ``d`` and returns the directory's path; ``n`` is an
int (a cube) or (nx, ny, nz).
"""
from __future__ import annotations

import math
import os

import numpy as np

from ..physics.forcing import shell_vectors


def _write(d, files):
    d = str(d)
    os.makedirs(os.path.join(d, "src"), exist_ok=True)
    for name, text in files.items():
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    return d


def _cparam(n):
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    return ("integer, parameter :: ncpus=1,nprocx=1,nprocy=1,"
            "nprocz=ncpus/(nprocx*nprocy)\n"
            f"integer, parameter :: nxgrid={nx},nygrid={ny},nzgrid={nz}\n")


def helical_mhdturb(d, n, nt=20, it1=10, isave=100, b_ext=None,
                    fcont=None):
    """helical-MHDturb's shape; ``b_ext`` = (Bx, By, Bz) imposes that
    uniform field (``B_ext`` in &magnetic_run_pars); ``fcont`` = (profile,
    ampl_ff, k1_ff) drives the flow by that continuous forcing in place of
    the helical kicks (``lforcing_cont=T``, ``iforce='zero'``, no k.dat):
    with 'ABC', the ABC-flow dynamo in this box."""
    kk = shell_vectors(3.0, 0.5)
    kav = float(np.sqrt((kk ** 2).sum(1)).mean())
    kdat = f"{len(kk)} {kav!r}\n" + "\n".join(
        " ".join(f"{v:.1f}" for v in kk[:, a]) for a in range(3)) + "\n"
    x0, lx = repr(-math.pi), repr(2.0 * math.pi)
    mag = "  eta=5e-3" + ("" if b_ext is None else ", B_ext=" + ",".join(
        repr(float(b)) for b in b_ext))
    if fcont is None:
        forcing = "  iforce='helical', force=0.07, relhel=1., kf=3."
    else:
        prof, ampl, k1 = fcont
        forcing = (f"  iforce='zero', lforcing_cont=T, iforcing_cont="
                   f"'{prof}', ampl_ff={float(ampl)!r}, k1_ff={float(k1)!r}")
    return _write(d, {
        "src/cparam.local": _cparam(n),
        "src/Makefile.local": (
            "MPICOMM = nompicomm\nHYDRO = hydro\nDENSITY = density\n"
            "ENTROPY = noentropy\nMAGNETIC = magnetic\nGRAVITY = nogravity\n"
            "FORCING = forcing\nVISCOSITY = viscosity\nEOS = eos_idealgas\n"),
        "start.in": (
            "&init_pars\n  cvsid='$Id$',\n"
            f"  xyz0={x0},{x0},{x0}\n  Lxyz={lx},{lx},{lx}\n"
            "  random_gen='nr_f90'\n/\n"
            "&eos_init_pars\n  cs0=1., gamma=1.\n/\n"
            "&hydro_init_pars\n  inituu='gaussian-noise', ampluu=1e-3\n/\n"
            "&density_init_pars\n/\n"
            "&magnetic_init_pars\n  initaa='gaussian-noise', amplaa=1e-4\n/\n"),
        "run.in": (
            "&run_pars\n  cvsid='$Id$',\n"
            f"  nt={nt}, it1={it1}, isave={isave}, itorder=3\n"
            "  random_gen='nr_f90'\n/\n"
            "&eos_run_pars\n/\n&hydro_run_pars\n/\n&density_run_pars\n/\n"
            f"&forcing_run_pars\n{forcing}\n/\n"
            f"&magnetic_run_pars\n{mag}\n/\n"
            "&viscosity_run_pars\n  nu=5e-3, ivisc='nu-const'\n/\n"),
        "print.in": "t(1p,e10.3)\ndt(1p,e10.3)\nurms(1p,e10.3)\nbrms\n"
                    "umax\nrhom\n",
        **({"k.dat": kdat} if fcont is None else {})})


def conv_slab(d, n, nt=20, it1=10, isave=100, uu_ampl="1e-3",
              heatcond="K-const"):
    """conv-slab's run directory with the values of ``configs.conv_slab``;
    ``heatcond="kramers"`` puts Kramers opacity (K₀ of
    ``configs.KRAMERS_K0``, n = 1) in place of K-const."""
    from ..configs import KRAMERS_K0
    cond = {"K-const": "iheatcond='K-const', hcond0=8e-3, ",
            "kramers": f"iheatcond='kramers', hcond0_kramers={KRAMERS_K0!r}, "
                       "nkramers=1., "}[heatcond]
    bcz = "  bcz='s','s','a','a2','c1:cT'\n"
    return _write(d, {
        "src/cparam.local": _cparam(n),
        "src/Makefile.local": (
            "HYDRO = hydro\nDENSITY = density\nENTROPY = entropy\n"
            "MAGNETIC = nomagnetic\nGRAVITY = gravity_simple\n"
            "VISCOSITY = viscosity\n"),
        "start.in": (
            "&init_pars\n  xyz0=-0.5,-0.5,-0.68\n  Lxyz=1.,1.,1.\n"
            f"  lperi=T,T,F\n{bcz}/\n"
            "&eos_init_pars\n  cs0=1., cp=1.\n/\n"
            f"&hydro_init_pars\n  inituu='gaussian-noise', ampluu={uu_ampl}\n"
            "/\n&density_init_pars\n  initlnrho='piecew-poly'\n/\n"
            "&grav_init_pars\n  gravz_profile='const', gravz=-1., z1=-0.5, "
            "z2=0.\n/\n"
            "&entropy_init_pars\n  initss='piecew-poly', mpoly0=1., "
            "mpoly1=3., mpoly2=0., isothtop=1\n/\n"),
        "run.in": (
            f"&run_pars\n  nt={nt}, it1={it1}, isave={isave}\n{bcz}/\n"
            "&eos_run_pars\n/\n&hydro_run_pars\n/\n&density_run_pars\n/\n"
            "&grav_run_pars\n/\n"
            f"&entropy_run_pars\n  {cond}"
            "luminosity=5e-3, wheat=0.1, cool=15., wcool=0.2, cs2cool=1.\n/\n"
            "&viscosity_run_pars\n  nu=4e-3\n/\n")})
