"""Load a reference-format run directory (start.in / run.in /
src/cparam.local / src/Makefile.local / print.in / k.dat) into a port
Config (counterpart of ``pencil_tpu/compat/rundir.py``; reference
contract: src/param_io.f90 namelists, src/cparam.local compile-time grid).

The port maps the groups whose modules it has, with the JAX loader's
rules: the grid and time step (uniform Cartesian, x and y periodic), eos
(ideal gas), density, hydro, grav, entropy, viscosity, magnetic (the
vector potential), forcing, shear, shock, the boundary conditions, and
the replay of the reference's random stream for the gaussian-noise
initial fields and the helical forcing (``random_gen`` 'nr_f90' or the
default 'min_std').  Everything else raises ``NotImplementedError`` naming
what it refused: a Makefile.local slot or a namelist group whose module
the port lacks, and a value the port's modules do not take.  A group the
JAX loader leaves unmapped is listed in ``info["unmapped_groups"]``, as
there; unknown parameters inside a mapped group are ignored, as there.

Three departures from the JAX loader: the Config has ``fused=True`` (a
run directory on the card takes a kernel chain), ``REAL_PRECISION =
double`` runs in float32, as the JAX loader does without x64 mode, which
it says once on stderr and in ``info["real_precision"]``, and
&shock_run_pars' ``lmax_shock`` is mapped (the JAX loader leaves the
Shock module's at True).
"""
from __future__ import annotations

import math
import os
import re
import sys
from typing import Dict, Tuple

from ..core.config import Config, GridSpec, TimeSpec
from ..core.farray import Registry
from ..integrate.timestep import RK_TABLES
from ..ops.boundary import BC, BC_REGISTRY, REFUSED
from ..physics import (Density, Entropy, EosIdealGas, Forcing, Gravity,
                       Hydro, Magnetic, Shear, Shock, Viscosity)
from .namelist import read_namelist_file

# Makefile.local slots of the port's modules and the values they take
SLOTS = {
    "HYDRO": ("hydro",),
    "DENSITY": ("density",),
    "EOS": ("eos_idealgas",),
    "ENTROPY": ("entropy", "noentropy"),
    "ENERGY": ("entropy", "noentropy"),
    "MAGNETIC": ("magnetic", "nomagnetic"),
    "GRAVITY": ("gravity_simple", "nogravity"),
    "FORCING": ("forcing", "noforcing"),
    "SHEAR": ("shear", "noshear"),
    "SHOCK": ("shock", "shock_highorder", "noshock"),
    "VISCOSITY": ("viscosity", "noviscosity"),
    "DERIV": ("deriv",),
    "TIMESTEP": ("timestep",),
}
# slots of the build that no physics depends on: any value
INFRASTRUCTURE = frozenset((
    "MPICOMM", "FOURIER", "FFT", "IO", "POWER", "DEBUG", "REAL_PRECISION",
    "SIGNAL", "SYSCALLS", "STRUCT_FUNC", "GHOSTFOLD", "SLICES", "TIMEAVG",
    "GSL", "FIXED_POINT", "STREAMLINES", "YINYANG", "GPU"))
# namelist stems of modules the port lacks (the JAX loader maps each): a
# non-empty &<stem>_init_pars or &<stem>_run_pars is refused
UNPORTED_GROUPS = (
    "dustdensity", "dustvelocity", "polymer", "cosmicray", "chiral",
    "neutralvelocity", "neutraldensity", "selfgrav", "poisson", "chemistry",
    "implicit_diff", "testfield", "pointmasses", "radiation", "pscalar",
    "ascalar", "particles", "particles_stalker", "particles_radius",
    "particles_number", "interstellar", "heatflux", "special")
# plain groups the JAX loader maps
UNPORTED_PLAIN = ("initial_condition_pars", "implicit_diffusion_run_pars")
# the iresistivity values that select the shock resistivity eta_shock
SHOCK_RESISTIVITY = ("eta-shock", "eta_shock", "shock")
# the initial conditions of the port's modules
INITS = {
    "hydro": ("zero", "nothing", "gaussian-noise"),
    "magnetic": ("zero", "nothing", "gaussian-noise"),
    "density": ("zero", "nothing", "gaussian-noise", "piecew-poly",
                "isothermal"),
    "entropy": ("zero", "nothing", "gaussian-noise", "piecew-poly"),
}


def _refuse(what):
    raise NotImplementedError(
        f"pencil_tpu_torch run directory: {what} (not ported)")


def _check(group, pars, neutral):
    """Refuse each parameter of ``pars`` that ``neutral`` lists at a value
    other than its neutral one (a callable: True where it is neutral)."""
    for key, ok in neutral.items():
        if key not in pars:
            continue
        v = pars[key]
        if not (ok(v) if callable(ok) else v == ok):
            _refuse(f"&{group}: {key}={v!r}")


def _zero3(v):
    return all(float(x or 0.0) == 0.0 for x in (v if isinstance(v, list)
                                                else [v]))


def _off(v):
    """A flag that is False everywhere (a scalar or an array)."""
    return not any(bool(x) for x in (v if isinstance(v, list) else [v]))


def parse_makefile_local(path) -> Dict[str, str]:
    """Module-slot assignments from a Makefile.local
    (e.g. INITIAL_CONDITION = initial_condition/kelvin_helmholtz)."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.split("#")[0]
            if "=" in line:
                k, v = line.split("=", 1)
                out[k.strip().upper()] = v.strip()
    return out


def parse_cparam_local(path) -> Dict[str, int]:
    """Extract name=value integer constants from a cparam.local.

    Values may be simple integer expressions over previously defined names
    (the reference uses e.g. ``nzgrid=1024/4``, ``nprocy=ncpus/nprocz``),
    evaluated left to right like the Fortran parameter statements."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            # magic header comments (mkcparam contract): dust bin count
            m_nd = re.match(r"\s*!\s*NDUSTSPEC CONTRIBUTION\s+(\d+)", line)
            if m_nd:
                out["ndustspec"] = int(m_nd.group(1))
            line = line.split("!")[0]
            if "::" in line:
                line = line.split("::", 1)[1]
            for part in line.split(","):
                m = re.match(r"\s*(\w+)\s*=\s*([\w+\-*/() ]+?)\s*$", part)
                if not m:
                    continue
                name, expr = m.group(1).lower(), m.group(2).lower()
                if not re.fullmatch(r"[0-9a-z_+\-*/() ]+", expr):
                    continue
                try:
                    out[name] = int(eval(expr, {"__builtins__": {}}, out))
                except Exception:
                    pass
    return out


def _check_slots(mkf):
    """Refuse a Makefile.local slot whose module the port lacks, or a
    value of a ported slot that it does not take."""
    for slot, value in mkf.items():
        if slot in INFRASTRUCTURE or not value:
            continue
        names = [w.split("/")[-1] for w in value.split()]
        allowed = SLOTS.get(slot)
        for nm in names:
            if allowed is not None:
                if nm not in allowed:
                    _refuse(f"Makefile.local {slot} = {value}")
            elif not nm.startswith("no"):
                _refuse(f"Makefile.local {slot} = {value}")


def _init_name(v, default="zero"):
    """initxx namelists can be ARRAYS (the reference ninit cascade) —
    keep lists as tuples so module init_fields can sum the entries."""
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        names = [str(x) for x in v]
        while names and names[-1] in ("", "nothing"):
            names.pop()
        if not names:
            return default
        if len(names) == 1:
            return names[0]
        return tuple(names)
    return str(v)


def _init_of(module, group, key, pars):
    """The module's init name from ``pars[key]``, refused unless the port's
    module implements it."""
    name = _init_name(pars.get(key))
    if name not in INITS[module]:
        _refuse(f"&{group}: {key}={pars.get(key)!r}")
    return name


def _as_tuple(v):
    return tuple(v) if isinstance(v, list) else (v,)


def _first(v):
    """Namelist arrays like kx_lnrho(ninit): take the first entry."""
    return v[0] if isinstance(v, list) else v


def _aniso3(v):
    """Per-axis coefficient triple from a namelist value (scalar or list)."""
    if isinstance(v, (list, tuple)):
        out = [float(x) for x in v][:3]
        while len(out) < 3:
            out.append(0.0)
        return tuple(out)
    return (float(v), float(v), float(v))


def _g(groups, name) -> Dict:
    return dict(groups.get(name, {}))


def _continuous(forcing):
    """The continuous-forcing fields of ``forcing`` where it is on, which
    the replay keeps; JAX's replay rebuilds Forcing without them (ROADMAP
    Queue 3), so where it is off the replayed module is JAX's."""
    if not forcing.lforcing_cont:
        return {}
    return {f: getattr(forcing, f) for f in (
        "lforcing_cont", "iforcing_cont", "ampl_ff", "k1_ff", "fcont_box")}


def _parity_replay(path, modules, grid, nt, init_pars, run_pars, cpar):
    """``random_gen='nr_f90'`` or 'min_std': reproduce the reference's
    machine-independent RNG stream through start.x's draw order
    (src/start.f90:383,416-423 — seed put, init_uu, init_lnrho,
    init_energy, init_aa) and precompute the run.x helical forcing draws
    (JAX rundir.py:182-441, the consumers the port has).

    Returns (overrides, modules): interior-field init overrides (numpy) and
    the module tuple with Forcing swapped to replay mode.  Each MPI rank of
    cparam.local draws its own stream over its local ghosted block; the
    interiors are put together."""
    import numpy as np

    from .pencil_rng import (Ran0, forcing_hel_sequence, gaunoise_vect,
                             read_k_dat, start_seed)

    gen = run_pars.get("random_gen", init_pars.get("random_gen", "min_std"))
    if gen not in ("nr_f90", "min_std"):
        return None, modules
    seed0 = int(init_pars.get("seed0", 1812))
    npx = int(cpar.get("nprocx", 1))
    npy = int(cpar.get("nprocy", 1))
    npz = int(cpar.get("nprocz", 1))
    nproc = npx * npy * npz

    def _make_rng(iproc):
        if gen == "nr_f90":
            return start_seed(seed0, iproc)
        # min_std: random_seed_wrapper(PUT) installs the seed verbatim
        # (no draw consumed) — src/general.f90 ran0 path
        return Ran0(-((seed0 - 1812 + 1) * 10 + iproc))

    rngs = [_make_rng(i) for i in range(nproc)]
    rng = rngs[0]
    nxl, nyl, nzl = grid.nx // npx, grid.ny // npy, grid.nz // npz
    overrides = {}

    def noise_for(mod, field, ncomp):
        if mod is None:
            return
        init = getattr(mod, "init", "nothing")
        ampl = float(getattr(mod, "ampl", 0.0))
        if init in ("gaussian-noise", "gaussian_noise") and ampl != 0.0:
            full = np.zeros((ncomp, grid.nx, grid.ny, grid.nz), np.float32)
            for ip in range(nproc):
                ipx = ip % npx
                ipy = (ip // npx) % npy
                ipz = ip // (npx * npy)
                loc = gaunoise_vect(rngs[ip], ampl, nxl + 6, nyl + 6,
                                    nzl + 6, ncomp)
                full[:, ipx * nxl:(ipx + 1) * nxl,
                     ipy * nyl:(ipy + 1) * nyl,
                     ipz * nzl:(ipz + 1) * nzl] = loc[:, 3:-3, 3:-3, 3:-3]
            overrides[field] = full if ncomp > 1 else full[0]

    by_name = {m.name: m for m in modules}
    # reference init cascade order (src/start.f90:416-423)
    noise_for(by_name.get("hydro"), "uu", 3)
    noise_for(by_name.get("density"), "lnrho", 1)
    noise_for(by_name.get("entropy"), "ss", 1)
    noise_for(by_name.get("magnetic"), "aa", 3)

    forc = by_name.get("forcing")
    kdat = os.path.join(path, "k.dat")
    if forc is not None and os.path.exists(kdat):
        nk, kav, kkx, kky, kkz = read_k_dat(kdat)
        kk, phase, phi = forcing_hel_sequence(rng, nt, kkx, kky, kkz)
        seq = tuple(
            (float(kk[i, 0]), float(kk[i, 1]), float(kk[i, 2]),
             float(phase[i]), float(phi[i]))
            for i in range(nt))
        eosm = by_name.get("eos")
        cs0eff = float(getattr(eosm, "cs0", 1.0)) if eosm is not None \
            else 1.0
        modules = tuple(
            Forcing(force=m.force, kf=m.kf, relhel=m.relhel,
                    sequence=seq, kav=kav,
                    # normalization uses cs0 unless overridden
                    # (forcing.f90:906-913)
                    cs0eff=(m.cs0eff if m.cs0eff != 1.0 else cs0eff),
                    lscale_kvector_tobox=m.lscale_kvector_tobox,
                    **_continuous(m))
            if m.name == "forcing" else m
            for m in modules)
    return (overrides or None), modules


def _grid_time(init_pars, run_pars, cpar, nxyz):
    """(GridSpec, TimeSpec) of start.in's &init_pars, run.in's &run_pars
    and cparam.local (JAX rundir.py:455-548)."""
    nx = nxyz[0] if nxyz else cpar.get("nxgrid", 32)
    ny = nxyz[1] if nxyz else cpar.get("nygrid", nx)
    nz = nxyz[2] if nxyz else cpar.get("nzgrid", nx)

    def _vec3(v, fill=None):
        # namelist scalar broadcast: xyz0=0. means (0,0,0); a short list
        # (xyz0=0.7, 0.0) leaves trailing components at their defaults
        # (cdata.f90:130 xyz0=-pi), passed via ``fill``
        if not isinstance(v, (list, tuple)):
            return [v, v, v]
        v = list(v)
        while len(v) < 3:
            v.append(fill[len(v)] if fill is not None else v[-1])
        return v

    xyz0 = _vec3(init_pars.get("xyz0", [-3.1416, -3.1416, -3.1416]),
                 fill=[-math.pi] * 3)
    if "xyz1" in init_pars:
        xyz1 = _vec3(init_pars["xyz1"],
                     fill=[a + 2.0 * math.pi for a in xyz0])
        Lxyz = [b - a for a, b in zip(xyz0, xyz1)]
    elif "wav1" in init_pars:
        # cubic box of size 2π/wav1 centred on the origin (start.f90:204)
        L1 = 2.0 * math.pi / float(init_pars["wav1"])
        Lxyz = [L1, L1, L1]
        xyz0 = [-L1 / 2.0] * 3
    else:
        Lxyz = _vec3(init_pars.get("lxyz", [6.2832, 6.2832, 6.2832]))
    lperi = init_pars.get("lperi", [True, True, True])
    if not isinstance(lperi, list):
        lperi = [lperi]
    lperi = [bool(p) for p in (list(lperi) + [True, True, True])[:3]]
    if not (lperi[0] and lperi[1]):
        _refuse(f"&init_pars: lperi={init_pars.get('lperi')!r} (a "
                "non-periodic x or y)")
    coords = str(init_pars.get("coord_system", "cartesian"))
    if coords != "cartesian":
        _refuse(f"&init_pars: coord_system={coords!r} (curvilinear "
                "coordinates)")
    # grid_func: Fortran namelist `array=scalar` fills element 1 only
    # (src/grid.f90 grid_func defaults to 'linear' per axis)
    gf = init_pars.get("grid_func", "linear")
    gf = (list(gf) if isinstance(gf, list) else [gf]) + ["linear"] * 3
    if any(str(f) not in ("linear", "") for f in gf[:3]):
        _refuse(f"&init_pars: grid_func={init_pars.get('grid_func')!r} (a "
                "non-uniform grid)")
    _check("init_pars", init_pars, {
        "lpole": _off, "lshift_origin": _off, "lcylinder_in_a_box": False,
        "lsphere_in_a_box": False, "llocal_iso": False,
        "lfargo_advection": False, "lcylindrical_gravity": False})
    gc = init_pars.get("coeff_grid", 0.0)
    gc = (list(gc) if isinstance(gc, list) else [gc]) + [0.0] * 3
    grid = GridSpec(nx=nx, ny=ny, nz=nz,
                    x0=xyz0[0], y0=xyz0[1], z0=xyz0[2],
                    Lx=Lxyz[0], Ly=Lxyz[1], Lz=Lxyz[2],
                    periodic=tuple(lperi),
                    grid_coeff=tuple(float(c) for c in gc[:3]),
                    xyz_star=tuple(float(v) for v in _vec3(
                        init_pars.get("xyz_star", [0.0, 0.0, 0.0]),
                        [0.0, 0.0, 0.0])))
    itorder = int(run_pars.get("itorder", 3))
    if itorder not in RK_TABLES:
        _refuse(f"&run_pars: itorder={itorder} (the 2N-RK orders "
                f"{sorted(RK_TABLES)})")
    time = TimeSpec(
        itorder=itorder,
        cdt=float(run_pars.get("cdt", 0.9)),
        cdtv=float(run_pars.get("cdtv", 0.25)),
        cdtv3=float(run_pars.get("cdtv3", 0.01)),
        cdts=float(run_pars.get("cdts", 1.0)),
        dt=float(run_pars.get("dt", 0.0)),
        dtmin=float(run_pars.get("dtmin", 1e-10)),
        dtmax=float(run_pars.get("dtmax", 1e37)),
        eps_rkf=float(run_pars.get("eps_rkf", 1e-8)),
        tstart=float(init_pars.get("tstart", 0.0)),
    )
    return grid, time


def _units(init_pars, eos_p):
    """(units, µ0 in code units, cp) of the run's unit system (JAX
    rundir.py:572-638, the ideal-gas branches)."""
    units = {k: float(init_pars[k]) for k in
             ("unit_length", "unit_velocity", "unit_density",
              "unit_temperature", "unit_magnetic") if k in init_pars}
    unit_system = str(init_pars.get("unit_system", "cgs"))
    if all(k in init_pars for k in ("c_light", "g_newton", "hbar")):
        # natural/Planck unit derivation (register.f90:460-492)
        cl = 2.99792458e10 / float(init_pars["c_light"])
        gf = 6.6742e-8 / float(init_pars["g_newton"])
        hf = 1.054571596e-27 / float(init_pars["hbar"])
        units["unit_velocity"] = cl
        units["unit_density"] = cl ** 5 / (gf ** 2 * hf)
        units["unit_length"] = math.sqrt(gf * hf / cl ** 3)
    # unit_magnetic default √4π, or the µ0=1-consistent value under
    # lfix_unit_std (register.f90:496-516); µ0 in code units follows as
    # µ0_sys·ρ_u·(u_u/B_u)² (:275,:295)
    mu0_sys = 4.0 * math.pi * (1e-7 if unit_system == "SI" else 1.0)
    if "unit_magnetic" not in units:
        if init_pars.get("lfix_unit_std"):
            units["unit_magnetic"] = (
                3.5449077018110318
                * math.sqrt((1e-7 if unit_system == "SI" else 1.0)
                            * units.get("unit_density", 1.0))
                * units.get("unit_velocity", 1.0))
        else:
            units["unit_magnetic"] = 3.5449077018110318
    mu0 = (mu0_sys * units.get("unit_density", 1.0)
           * (units.get("unit_velocity", 1.0)
              / units["unit_magnetic"]) ** 2) \
        if ("unit_density" in units or "unit_velocity" in units
            or "unit_magnetic" in init_pars) else 1.0
    gamma = float(eos_p.get("gamma", 5.0 / 3.0))
    cp = float(eos_p.get("cp", 1.0))
    if "unit_temperature" in units and "cp" not in eos_p \
            and not init_pars.get("lfix_unit_std"):
        # explicit unit_temperature: cp follows from the unit system
        # (eos_idealgas.f90:192-198)
        rsys = 1.3806505e-16 / 1.66053886e-24
        if unit_system == "SI":
            rsys *= 1e-4
        rgas = rsys * units["unit_temperature"] / units.get(
            "unit_velocity", 1.0) ** 2
        mu_eos = float(eos_p["mu"]) if "mu" in eos_p else 1.0
        cp = (rgas / mu_eos if gamma == 1.0
              else rgas * gamma / (mu_eos * (gamma - 1.0)))
    if init_pars.get("lfix_unit_std") and gamma != 1.0:
        cp = 1.0 / (gamma - 1.0)
    return units, mu0, cp


def load_rundir(path, nxyz=None) -> Tuple[Config, Dict]:
    """→ (Config, info) where info carries run_pars (nt, it1, ...), the
    replayed initial fields (``init_overrides``) and the groups left
    unmapped.  Raises NotImplementedError for what the port lacks."""
    path = str(path)
    start = read_namelist_file(os.path.join(path, "start.in"))
    runf = os.path.join(path, "run.in")
    run = read_namelist_file(runf) if os.path.exists(runf) else {}
    cpar = parse_cparam_local(os.path.join(path, "src", "cparam.local"))
    mkf = parse_makefile_local(os.path.join(path, "src", "Makefile.local"))
    _check_slots(mkf)

    init_pars = _g(start, "init_pars")
    run_pars = _g(run, "run_pars")
    _check("run_pars", run_pars, {
        "lweno_transport": False, "lisotropic_advection": False,
        "lfargo_advection": False, "lfreeze_varint": _off,
        "lfreeze_varext": _off})
    grid, time = _grid_time(init_pars, run_pars, cpar, nxyz)

    modules = []
    known = {"init_pars", "run_pars"}

    def grp(stem):
        known.update({f"{stem}_init_pars", f"{stem}_run_pars"})
        d = _g(start, f"{stem}_init_pars")
        r = dict(_g(run, f"{stem}_run_pars"))
        # init*='...' in a run-pars group only takes effect when the
        # module's lreinitialize_* flag is set (reference e.g.
        # hydro.f90:1004 `if (lreinitialize_uu)`)
        if not any(bool(v) for k, v in r.items()
                   if k.startswith("lreinitialize")):
            for k in [k for k in r if k.startswith("init")]:
                del r[k]
        d.update(r)
        return d

    for stem in UNPORTED_GROUPS:
        if grp(stem):
            _refuse(f"&{stem}_init_pars/&{stem}_run_pars (the port has no "
                    f"{stem} module)")
    for name in UNPORTED_PLAIN:
        known.add(name)
        if start.get(name) or run.get(name):
            _refuse(f"&{name} (the port has no such module)")

    eos_p = grp("eos")
    units, mu0, cp = _units(init_pars, eos_p)
    if eos_p or "eos_init_pars" in start or "density_init_pars" in start:
        modules.append(EosIdealGas(
            gamma=float(eos_p.get("gamma", 5.0 / 3.0)),
            cs0=float(eos_p.get("cs0", 1.0)),
            rho0=float(eos_p.get("rho0", 1.0)),
            cp=cp))

    den_p = grp("density")
    ent_p0 = _g(start, "entropy_init_pars")
    if "density_init_pars" in start or den_p:
        _check("density", den_p, {
            "ldensity_nolog": False, "lrelativistic_eos": False,
            "beta_glnrho_global": _zero3, "lfreeze_lnrhoint": False,
            "lfreeze_lnrhoext": False})
        modules.append(Density(
            init=_init_of("density", "density_init_pars", "initlnrho",
                          den_p),
            ampl=float(_first(den_p.get("ampllnrho", 0.0))),
            width=float(den_p.get("widthlnrho", 0.05)),
            lupw_lnrho=bool(den_p.get("lupw_lnrho", False)),
            # Fickian diffusion, cdiffrho where diffrho is not given (JAX
            # rundir.py:723)
            diffrho=float(den_p.get("diffrho", den_p.get("cdiffrho", 0.0))),
            diffrho_shock=float(den_p.get("diffrho_shock", 0.0)),
            diffrho_hyper3=float(den_p.get("diffrho_hyper3", 0.0)),
            lhyper3_polar=any("sph" in str(v) or "cyl" in str(v)
                              for v in _as_tuple(den_p.get("idiff", ""))),
            diffrho_hyper3_mesh=float(den_p.get("diffrho_hyper3_mesh", 0.0)),
            diffrho_hyper3_aniso=_aniso3(
                den_p.get("diffrho_hyper3_aniso", 0.0))))

    hyd_p = grp("hydro")
    if "beta_glnrho_global" in ent_p0 and not _zero3(
            ent_p0["beta_glnrho_global"]):
        _refuse(f"&entropy_init_pars: beta_glnrho_global="
                f"{ent_p0['beta_glnrho_global']!r}")
    if "hydro_init_pars" in start or hyd_p:
        _check("hydro", hyd_p, {
            "urand": 0.0, "dampuext": 0.0,
            "dampuint": 0.0, "lomega_int": False,
            "lcdt_tauf": False,
            "lpressuregradient_gas": True, "lfreeze_uint": False,
            "lfreeze_uext": False})
        modules.append(Hydro(
            init=_init_of("hydro", "hydro_init_pars", "inituu", hyd_p),
            ampl=float(_first(hyd_p.get("ampluu",
                                        hyd_p.get("max_uu", 0.0)))),
            Omega=float(hyd_p.get("omega", 0.0)),
            theta=float(hyd_p.get("theta", 0.0)),
            lupw_uu=bool(hyd_p.get("lupw_uu", False)),
            lremove_mean_momenta=bool(
                hyd_p.get("lremove_mean_momenta", False))))

    grav_p = grp("grav")
    if grav_p and "nogravity" not in mkf.get("GRAVITY", "nogravity"):
        # a grav_*_pars namelist with GRAVITY=nogravity is dead config the
        # reference ignores
        _check("grav", grav_p, {"lcylindrical_gravity": False})
        gprof = str(grav_p.get("gravz_profile", "const"))
        gz = float(grav_p.get("gravz", 0.0))
        if gprof == "linear":
            # g_z = −ν_epi²·z (gravity_simple.f90 'linear')
            gz = -float(grav_p.get("nu_epicycle", 1.0)) ** 2
        modules.append(Gravity(
            gravz_profile=gprof,
            gravx_profile=str(grav_p.get("gravx_profile", "const")),
            gravx=float(grav_p.get("gravx", 0.0)),
            gravz=gz,
            zinfty=float(grav_p.get("zinfty", 0.0)),
            unit_length=units.get("unit_length", 1.0),
            unit_velocity=units.get("unit_velocity", 1.0),
            ipotential=str(_first(grav_p.get("ipotential", "")))))

    ent_p = grp("entropy")
    ent_slot = mkf.get("ENTROPY", mkf.get("ENERGY", ""))
    if "initeth" in ent_p or "initlntt" in ent_p \
            or ent_p.get("ltemperature_nolog"):
        _refuse("&entropy_*_pars with initeth/initlnTT/ltemperature_nolog "
                "(the thermal-energy and temperature modules)")
    if ("entropy" in ent_slot and "noentropy" not in ent_slot) or ent_p:
        # NOTE: an empty &entropy_init_pars group alone does NOT select
        # the module — the Makefile default is ENERGY=noentropy
        _check("entropy", ent_p, {
            "cooltype": "",
            "chi_hyper3": 0.0, "chi_hyper3_mesh": 0.0,
            "chi_hyper3_aniso": _zero3,
            "lthdiff_hmax": False, "rcool": 0.0,
            "lchit_fluct": False, "lread_hcond": False,
            "lfreeze_sint": False, "lfreeze_sext": False})
        # MLT runs: hcond0 and Fbot derive from mixinglength_flux (JAX
        # rundir.py:1170-1180; initialize_energy, entropy.f90:669-671)
        mlf = float(ent_p.get("mixinglength_flux", 0.0))
        hcond0 = float(ent_p.get("hcond0", 0.0))
        fbot = float(ent_p.get("fbot", 0.0))
        if mlf != 0.0 and hcond0 == 0.0:
            game = float(eos_p.get("gamma", 5.0 / 3.0))
            hcond0 = (-mlf * (float(ent_p.get("mpoly0", 1.5)) + 1.0)
                      * (game - 1.0) / game
                      / float(grav_p.get("gravz", -1.0)))
            if fbot == 0.0:
                fbot = mlf
        modules.append(Entropy(
            init=_init_of("entropy", "entropy_init_pars", "initss", ent_p),
            ampl=float(_first(ent_p.get(
                "ampl_ss", ent_p.get("ss_const", 0.0)))),
            width=float(ent_p.get("widthss", 0.05)),
            iheatcond=_as_tuple(ent_p.get("iheatcond", "K-const")),
            hcond0=hcond0,
            chi=float(ent_p.get("chi", 0.0)),
            chi_shock=float(ent_p.get("chi_shock", 0.0)),
            # Entropy's other conduction and cooling terms, as JAX's
            # loader maps them (pencil_tpu/compat/rundir.py:1203-1238)
            hcond0_kramers=float(ent_p.get("hcond0_kramers", 0.0)),
            nkramers=float(ent_p.get("nkramers", 1.0)),
            chimax_kramers=float(ent_p.get("chimax_kramers", 0.0)),
            chimin_kramers=float(ent_p.get("chimin_kramers", 0.0)),
            chi_cspeed=float(ent_p.get("chi_cspeed", 0.5)),
            tau_cool=float(ent_p.get("tau_cool", 0.0)),
            TTref_cool=float(ent_p.get("ttref_cool", 0.0)),
            heat_uniform=float(ent_p.get("heat_uniform", 0.0)),
            cool_uniform=float(ent_p.get("cool_uniform", 0.0)),
            lupw_ss=bool(ent_p.get("lupw_ss", False)),
            luminosity=float(ent_p.get("luminosity", 0.0)),
            wheat=float(ent_p.get("wheat", 0.1)),
            cool=float(ent_p.get("cool", 0.0)),
            wcool=float(ent_p.get("wcool", 0.2)),
            zcool=float(ent_p.get("zcool", 0.0)),
            cooling_profile=str(ent_p.get("cooling_profile", "gaussian")),
            cs2cool=float(ent_p.get("cs2cool", 0.0)),
            mpoly0=float(ent_p.get("mpoly0", 1.0)),
            mpoly1=float(ent_p.get("mpoly1", 3.0)),
            mpoly2=float(ent_p.get("mpoly2", 0.0)),
            z1=float(grav_p.get("z1", ent_p.get("z1", 0.0))),
            z2=float(grav_p.get("z2", ent_p.get("z2", 1.0))),
            isothtop=int(ent_p.get("isothtop", 1)),
            # the flux walls' fields (JAX rundir.py:1224-1233)
            sigmaSBt=float(run_pars.get(
                "sigmasbt", eos_p.get("sigmasbt",
                                      init_pars.get("sigmasbt", 0.0)))),
            chi_t=float(ent_p.get("chi_t", 0.0)),
            chit_prof1=float(ent_p.get("chit_prof1", 1.0)),
            chit_prof2=float(ent_p.get("chit_prof2", 1.0)),
            Fbot=fbot, Ftop=float(ent_p.get("ftop", 0.0))))

    vis_p = grp("viscosity")
    if vis_p:
        _check("viscosity", vis_p, {"limplicit_viscosity": False})
        modules.append(Viscosity(
            ivisc=tuple(str(v) for v in _as_tuple(
                vis_p.get("ivisc", "nu-const"))),
            nu=float(vis_p.get("nu", 0.0)),
            nu_hyper3=float(vis_p.get("nu_hyper3", 0.0)),
            nu_shock=float(vis_p.get("nu_shock", 0.0)),
            # the other flavours' coefficients (JAX rundir.py:1265-1274)
            nu_cspeed=float(vis_p.get("nu_cspeed", 0.5)),
            zeta=float(vis_p.get("zeta", 0.0)),
            nu_aniso_hyper3=_aniso3(vis_p.get("nu_aniso_hyper3", 0.0)),
            # JAX's loader leaves ν₃ᵐ at its default of 5 whatever the run
            # sets (pencil_tpu/compat/rundir.py:1262-1274): the port reads
            # it, as the reference does
            nu_hyper3_mesh=float(vis_p.get("nu_hyper3_mesh", 5.0))))

    mag_p = grp("magnetic")
    if ("magnetic_init_pars" in start or mag_p) \
            and "nomagnetic" not in mkf.get("MAGNETIC", "magnetic"):
        for stem in ("magn_mf", "magn_mf_demfdt"):
            if grp(stem):
                _refuse(f"&{stem}_init_pars/&{stem}_run_pars (mean-field "
                        "magnetic)")
        ires = [str(v) for v in _as_tuple(mag_p.get("iresistivity", ""))]
        bad = [v for v in ires if v not in ("", "eta-const", "hyper3")
               + SHOCK_RESISTIVITY]
        if bad:
            _refuse(f"&magnetic: iresistivity={bad!r}")
        _check("magnetic", mag_p, {
            "lweyl_gauge": False,
            "limplicit_resistivity": False, "ladvective_gauge": False,
            "lboris_correction": False, "battery_term": 0.0,
            "hall_term": 0.0, "llorentzforce": True,
            "lfreeze_aint": False, "lfreeze_aext": False})
        if mu0 != 1.0:
            _refuse(f"&init_pars: a unit system with mu0 = {mu0!r} in code "
                    "units")
        modules.append(Magnetic(
            init=_init_of("magnetic", "magnetic_init_pars", "initaa", mag_p),
            ampl=float(_first(mag_p.get("amplaa", 0.0))),
            eta=float(mag_p.get("eta", 0.0)),
            eta_hyper3=float(mag_p.get("eta_hyper3", 0.0)),
            # the shock resistivity where iresistivity names it (JAX
            # rundir.py:1509-1512)
            eta_shock=float(mag_p.get("eta_shock", 0.0))
            if set(SHOCK_RESISTIVITY) & set(ires) else 0.0,
            lohmic_heat=bool(mag_p.get("lohmic_heat", True)),
            # a short list sets the leading components (Fortran)
            B_ext=tuple(float(b) for b in (list(_as_tuple(
                mag_p.get("b_ext", 0.0))) + [0.0, 0.0])[:3])))

    for_p = grp("forcing")
    if for_p:
        iforce = str(for_p.get("iforce", "zero"))
        if iforce not in ("zero", "helical"):
            _refuse(f"&forcing: iforce={iforce!r} (zero and helical)")
        kf = float(for_p.get("kf", 0.0))
        kdat = os.path.join(path, "k.dat")
        if kf == 0.0 and os.path.exists(kdat):
            # first line of k.dat: n_vectors, mean |k|
            with open(kdat) as f:
                kf = float(f.readline().split()[1])
        modules.append(Forcing(
            # reference default iforce='zero' → no stochastic kick
            force=(float(for_p.get("force", 0.02))
                   if iforce != "zero" else 0.0),
            kf=kf or 3.0,
            relhel=float(for_p.get("relhel", 1.0)),
            lscale_kvector_tobox=bool(
                for_p.get("lscale_kvector_tobox", False)),
            # continuous forcing (JAX rundir.py:1569-1576): the first
            # profile of iforcing_cont, 'xz' over the grid's x and z
            lforcing_cont=bool(for_p.get("lforcing_cont", False)),
            iforcing_cont=str(_first(for_p.get("iforcing_cont", ""))),
            ampl_ff=float(_first(for_p.get("ampl_ff", 0.0))),
            k1_ff=float(for_p.get("k1_ff", 1.0)),
            fcont_box=(grid.x0, grid.x0 + grid.Lx,
                       grid.z0, grid.z0 + grid.Lz)))

    shear_p = grp("shear")
    if shear_p:
        modules.append(Shear(
            qshear=float(shear_p.get("qshear", 1.5)),
            Omega=float(shear_p.get("omega", hyd_p.get("omega", 1.0))),
            Sshear=float(shear_p.get("sshear", 0.0)),
            lshearadvection_as_shift=bool(
                shear_p.get("lshearadvection_as_shift", False))))

    shk_p = grp("shock")
    shock_slot = mkf.get("SHOCK", "")
    if (shk_p or any("shock" in str(v) for v in
                     _as_tuple(vis_p.get("ivisc", "")))
            or float(ent_p.get("chi_shock", 0.0)) != 0.0
            or ("shock" in shock_slot and "noshock" not in shock_slot)):
        # every switch of &shock_run_pars (JAX rundir.py:1635-1650, which
        # leaves lmax_shock at its default)
        modules.append(Shock(
            variant="highorder" if "highorder" in shock_slot
            else "original",
            ishock_max=int(shk_p.get("ishock_max", 1)),
            lgaussian_smooth=bool(shk_p.get("lgaussian_smooth", False)),
            lconvergence_only=bool(shk_p.get("lconvergence_only", True)),
            shock_div_pow=float(shk_p.get("shock_div_pow", 1.0)),
            lmax_shock=bool(shk_p.get("lmax_shock", True))))

    modules = tuple(modules)
    bcs = _boundary_conditions(modules, init_pars, run_pars, units)
    overrides, modules = _parity_replay(
        path, modules, grid, int(run_pars.get("nt", 100)),
        init_pars, run_pars, cpar)
    cfg = Config(grid=grid, time=time, modules=modules, fused=True,
                 bcx=bcs[0], bcy=bcs[1], bcz=bcs[2])
    unmapped = [g for g in list(start) + list(run) if g not in known]
    info = {
        "init_overrides": overrides,
        "run_pars": run_pars,
        "unmapped_groups": sorted(set(unmapped)),
        "nt": int(run_pars.get("nt", 100)),
        "it1": int(run_pars.get("it1", 10)),
        "isave": int(run_pars.get("isave", 200)),
        "dsnap": float(run_pars.get("dsnap", 0.0)),
        "dvid": float(run_pars.get("dvid", 0.0)),
    }
    if "double" in mkf.get("REAL_PRECISION", ""):
        info["real_precision"] = "double, run in float32"
        print(f"pencil_tpu_torch: {path}: REAL_PRECISION = double runs in "
              "float32", file=sys.stderr)
    return cfg, info


def _boundary_conditions(modules, init_pars, run_pars, units):
    """(bcx, bcy, bcz): run.in's codes over start.in's, one per
    communicated component in registration order, with fbc values and the
    derived 'cT', 'ism' and 'c1' values (JAX rundir.py:2346-2412)."""
    from ..model import REGISTRATION_ORDER, _order_key
    reg = Registry()
    for m in sorted(modules, key=_order_key(REGISTRATION_ORDER)):
        m.register(reg)
    reg.finalize()
    comp_names = reg.comp_names[: reg.ncom]
    by_name = {m.name: m for m in modules}
    ent, grav, eos = (by_name.get(k) for k in ("entropy", "gravity", "eos"))

    def bcs_for(axis_key):
        codes = run_pars.get(axis_key, init_pars.get(axis_key))
        if codes is None:
            return ()
        codes = codes if isinstance(codes, list) else [codes]
        # per-component BC values: fbcz = bottom, fbcz2 = top
        fbc_lo = init_pars.get("f" + axis_key,
                               init_pars.get("f" + axis_key + "1",
                                             run_pars.get("f" + axis_key)))
        fbc_hi = init_pars.get("f" + axis_key + "2",
                               run_pars.get("f" + axis_key + "2"))
        fbc_lo = fbc_lo if isinstance(fbc_lo, list) else None
        fbc_hi = fbc_hi if isinstance(fbc_hi, list) else None
        pairs = [(c, code, i) for i, (c, code) in
                 enumerate(zip(comp_names, codes))]
        # apply density BCs before entropy (cT/c1 read lnrho ghosts)
        pairs.sort(key=lambda p: 1 if p[0] == "ss" else 0)
        out = []
        for comp, code, ci in pairs:
            vals = [0.0, 0.0]
            parts = str(code).split(":")
            for side, c in ((0, parts[0]), (1, parts[-1])):
                if c in REFUSED:
                    _refuse(f"{axis_key}: {comp} {code!r} ({c!r} "
                            f"{REFUSED[c]})")
                if c not in BC_REGISTRY:
                    _refuse(f"{axis_key}: {comp} {code!r} (the BC "
                            f"mnemonics {sorted(BC_REGISTRY)})")
                arr = fbc_lo if side == 0 else fbc_hi
                v = float(arr[ci]) if arr is not None and ci < len(arr) \
                    else 0.0
                if c == "cT" and ent is not None and ent.cs2cool > 0:
                    v = ent.cs2cool
                elif c == "ism":
                    # the observed scale height: density_scale_factor or
                    # 900 pc / unit_length (boundcond.f90:8613-8617)
                    dsf = run_pars.get("density_scale_factor",
                                       init_pars.get("density_scale_factor"))
                    v = float(dsf) if dsf is not None else \
                        2.7774e21 / units.get("unit_length", 1.0)
                elif c == "c1" and ent is not None and grav is not None \
                        and eos is not None:
                    # equilibrium flux F/K = −dT/dz of the bottom polytrope:
                    # dT/dz = γ·gravz/((m+1)(γ−1)cp)
                    mlay = ent.mpoly1 if side == 0 else ent.mpoly2
                    v = -eos.gamma * grav.gravz / (
                        (mlay + 1.0) * (eos.gamma - 1.0) * eos.cp)
                vals[side] = v
            out.append(BC.parse(comp, str(code), vals[0], vals[1]))
        return tuple(out)

    return bcs_for("bcx"), bcs_for("bcy"), bcs_for("bcz")


def load_print_in(path) -> tuple:
    """print.in → print_columns for RunParams."""
    from ..io.timeseries import parse_print_in
    p = os.path.join(str(path), "print.in")
    if not os.path.exists(p):
        return ("it", "t", "dt", "urms", "umax", "rhom")
    with open(p) as f:
        return tuple(parse_print_in(f.read()))
