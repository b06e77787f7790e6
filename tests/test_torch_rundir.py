"""The run-directory loader of pencil_tpu_torch against pencil_tpu's, on
the CPU: the namelist parser on a corpus of texts; the reference random
streams (``MarsRan``, ``Ran0``) drawn, gaussian noise made and the helical
forcing sequence drawn bit for bit as JAX's scalar code does; two run
directories written here in the shapes of the reference samples
``helical-MHDturb`` (with a ``k.dat``) and ``conv-slab`` loaded into the
same modules, boundary conditions, time step, info and replayed initial
fields as the JAX loader gives, and into ``configs.flagship`` and
``configs.conv_slab``; the replayed forcing kick against JAX's
``_replay`` (with Shear at t ≠ 0); the var.dat codec; and a refusal that
names its slot, group or value for everything the port lacks.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu.compat.pencil_rng as jrng
import pencil_tpu_torch as pt
import pencil_tpu_torch.compat.pencil_rng as trng
from pencil_tpu.compat.namelist import parse_namelists as jax_parse
from pencil_tpu.compat.rundir import load_rundir as jax_load
from pencil_tpu.core.grid import make_grid as jax_make_grid
from pencil_tpu_torch.compat import io_dist, samples
from pencil_tpu_torch.compat.namelist import parse_namelists
from pencil_tpu_torch.compat.rundir import load_rundir
from pencil_tpu_torch.core.grid import make_grid
from pencil_tpu_torch.model import Model
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.physics.forcing import shell_vectors
from pencil_tpu_torch.post import read as pread

torch.set_num_threads(1)

HELICAL_N = 8
CONV_N = (8, 8, 16)


# ---- the two run directories -------------------------------------------------
def helical_rundir(d, nt=6):
    """helical-MHDturb's shape with the values of ``configs.flagship``."""
    return samples.helical_mhdturb(d, HELICAL_N, nt=nt, it1=2)


def conv_rundir(d, nt=6, uu_ampl="1e-3"):
    """conv-slab's shape with the values of ``configs.conv_slab``."""
    return samples.conv_slab(d, CONV_N, nt=nt, it1=2, uu_ampl=uu_ampl)


def _edited(d, edits, columns=()):
    """Edit the run directory ``d`` in place: each (file, old, new) of
    ``edits`` once, ``columns`` appended to print.in (columns that are
    never negative: a negative value fills its width and runs into the
    one before it); returns ``d``."""
    for name, old, new in edits:
        path = os.path.join(d, name)
        with open(path) as f:
            text = f.read()
        assert old in text, (name, old)
        with open(path, "w") as f:
            f.write(text.replace(old, new, 1))
    with open(os.path.join(d, "print.in"), "a") as f:
        f.write("".join(c + "\n" for c in columns))
    return d


def bext_rundir(d, nt=4):
    """helical-MHDturb's shape in an imposed field B_ext = (0, 0, 0.1),
    printing the extrema of B without it and the mean field along z."""
    return _edited(samples.helical_mhdturb(d, HELICAL_N, nt=nt, it1=2,
                                           b_ext=(0.0, 0.0, 0.1)), [],
                   columns=("bbzmax", "bmz"))


def fcont_rundir(d, nt=4):
    """The ABC-flow dynamo in helical-MHDturb's shape: continuous forcing
    'ABC' in place of the helical kicks."""
    return samples.helical_mhdturb(d, HELICAL_N, nt=nt, it1=2,
                                   fcont=("ABC", 0.1, 1.0))


def visc_rundir(d, nt=4):
    """conv-slab's shape (velocity noise of 1e-2) with the momentum-
    conserving viscosity 'rho-nu-const' (ν = 4e-3) and the bulk viscosity
    ζ = 1e-3 in place of nu-const, and Fickian mass diffusion D = 4e-3."""
    return _edited(conv_rundir(d, nt=nt, uu_ampl="1e-2"), [
        ("run.in", "&viscosity_run_pars\n  nu=4e-3\n",
         "&viscosity_run_pars\n  nu=4e-3, ivisc='rho-nu-const',"
         "'rho-nu-const-bulk', zeta=1e-3\n"),
        ("run.in", "&density_run_pars\n", "&density_run_pars\n"
         "  diffrho=4e-3\n")])


def nu_therm_rundir(d, nt=4):
    """conv-slab's shape (velocity noise of 1e-2) with the temperature-
    dependent viscosity 'nu-therm', ν T^½, in place of nu-const."""
    return _edited(conv_rundir(d, nt=nt, uu_ampl="1e-2"), [
        ("run.in", "&viscosity_run_pars\n  nu=4e-3\n",
         "&viscosity_run_pars\n  nu=4e-3, ivisc='nu-therm', "
         "nu_cspeed=0.5\n")])


def kramers_rundir(d, nt=4):
    """conv-slab's shape (velocity noise of 1e-2) with Kramers opacity in
    place of K-const (K₀ of configs.KRAMERS_K0, n = 1, clipped to χ in
    [2e-3, 2e-2]), Newtonian cooling towards T = 1.5 on τ = 2 and the
    cooling layer's 'cubic_step' profile."""
    return _edited(conv_rundir(d, nt=nt, uu_ampl="1e-2"), [
        ("run.in", "iheatcond='K-const', hcond0=8e-3, ",
         "iheatcond='kramers', hcond0_kramers=1.6662656847e-3, "
         "nkramers=1., chimin_kramers=2e-3, chimax_kramers=2e-2, "
         "tau_cool=2., TTref_cool=1.5, cooling_profile='cubic_step', ")])


def chi_hyper3_rundir(d, nt=4):
    """conv-slab's shape (velocity noise of 1e-2) with the del6
    hyper-diffusion of s, χ₃ = 5e-3·Δ⁵ ('hyper3' in iheatcond), and
    Newtonian cooling towards T = 1.5 on τ = 2."""
    return _edited(conv_rundir(d, nt=nt, uu_ampl="1e-2"), [
        ("run.in", "iheatcond='K-const', ",
         "iheatcond='K-const','hyper3', chi_hyper3=1.52587890625e-7, "
         "tau_cool=2., TTref_cool=1.5, ")])


def radiative_rundir(d, nt=4):
    """The Kramers conv-slab directory (velocity noise of 1e-2) with a
    black-body top (ss 'c1:Fgs', σ_SBt of ``configs.fgs_sigma``, the
    turbulent χ_t with its profile factor at the top) above a hydrostatic
    density top (lnρ 'a2:hs')."""
    from pencil_tpu_torch.configs import fgs_sigma
    return _edited(samples.conv_slab(d, CONV_N, nt=nt, it1=2, uu_ampl="1e-2",
                                     heatcond="kramers"), [
        ("run.in", "bcz='s','s','a','a2','c1:cT'",
         f"bcz='s','s','a','a2:hs','c1:Fgs', sigmaSBt={fgs_sigma()!r}"),
        ("run.in", "cs2cool=1.", "cs2cool=1., chi_t=1e-3, chit_prof2=2.")])


def vacuum_rundir(d, nt=4):
    """The conv-slab directory (velocity noise of 1e-2) made
    magnetoconvection (η = 4e-3, A noise of 1e-2) with a vacuum exterior:
    ax, ay, az 'pot' at both walls."""
    bcz = ("bcz='s','s','a','a2','c1:cT'",
           "bcz='s','s','a','a2','c1:cT','pot','pot','pot'")
    return _edited(conv_rundir(d, nt=nt, uu_ampl="1e-2"), [
        ("src/Makefile.local", "MAGNETIC = nomagnetic",
         "MAGNETIC = magnetic"),
        ("start.in", "&density_init_pars",
         "&magnetic_init_pars\n  initaa='gaussian-noise', amplaa=1e-2\n/\n"
         "&density_init_pars"),
        ("run.in", "&viscosity_run_pars",
         "&magnetic_run_pars\n  eta=4e-3\n/\n&viscosity_run_pars"),
        ("start.in",) + bcz, ("run.in",) + bcz])


def upwind_rundir(d, nt=4):
    """conv-slab's shape (velocity noise of 1e-2) with the advection of
    lnρ, u and s upwinded: lupw_lnrho, lupw_uu, lupw_ss."""
    return _edited(conv_rundir(d, nt=nt, uu_ampl="1e-2"), [
        ("run.in", "&hydro_run_pars\n/\n&density_run_pars\n/\n",
         "&hydro_run_pars\n  lupw_uu=T\n/\n"
         "&density_run_pars\n  lupw_lnrho=T\n/\n"),
        ("run.in", "hcond0=8e-3, ", "hcond0=8e-3, lupw_ss=T, ")])


def shock_rundir(d, nt=4):
    """helical-MHDturb's shape with an entropy field (γ = 5/3, chi-const
    χ = 1e-3) and the whole shock-capturing set: the Shock module,
    nu-shock, diffrho_shock, the shock resistivity (iresistivity
    'eta-shock') and shock conduction (iheatcond 'shock'), each 1."""
    return _edited(helical_rundir(d, nt=nt), [
        ("src/Makefile.local", "ENTROPY = noentropy",
         "ENTROPY = entropy\nSHOCK = shock"),
        ("start.in", "cs0=1., gamma=1.", "cs0=1., gamma=1.6666667, cp=1."),
        ("start.in", "&density_init_pars\n/\n",
         "&density_init_pars\n/\n&entropy_init_pars\n/\n"),
        ("run.in", "&density_run_pars\n/\n",
         "&density_run_pars\n  diffrho_shock=1.\n/\n"
         "&entropy_run_pars\n  iheatcond='chi-const','shock', chi=1e-3, "
         "chi_shock=1.\n/\n"),
        ("run.in", "  eta=5e-3", "  eta=5e-3, iresistivity='eta-const',"
         "'eta-shock', eta_shock=1."),
        ("run.in", "nu=5e-3, ivisc='nu-const'",
         "nu=5e-3, nu_shock=1., ivisc='nu-const','nu-shock'")])


def shock_highorder_rundir(d, nt=4):
    """``shock_rundir`` with the reference's shock_highorder module and
    switches of &shock_run_pars: the maximum over ±2 cells, 'gaussian'
    7-point smoothing."""
    return _edited(shock_rundir(d, nt=nt), [
        ("src/Makefile.local", "SHOCK = shock", "SHOCK = shock_highorder"),
        ("run.in", "&density_run_pars\n",
         "&shock_run_pars\n  ishock_max=2, lgaussian_smooth=T\n/\n"
         "&density_run_pars\n")])


def conv_shock_rundir(d, nt=4):
    """conv-slab's shape (velocity noise of 5e-2) with the Shock module
    between its walls: nu-shock (ν_sh = 1) beside ν, and the slot's bcz
    code 's' in start.in and run.in."""
    bcz = "bcz='s','s','a','a2','c1:cT'"
    return _edited(conv_rundir(d, nt=nt, uu_ampl="5e-2"), [
        ("src/Makefile.local", "VISCOSITY = viscosity",
         "VISCOSITY = viscosity\nSHOCK = shock"),
        ("start.in", bcz, bcz + ",'s'"), ("run.in", bcz, bcz + ",'s'"),
        ("run.in", "nu=4e-3", "nu=4e-3, nu_shock=1., "
         "ivisc='nu-const','nu-shock'")])


def safi_rundir(d, nt=4):
    """helical-MHDturb's shape in a rotating shearing box (Ω = 1, q =
    3/2) with SAFI, the mesh flavour of del6 on u and lnρ (ν₃ᵐ = D₃ᵐ =
    5), η₃ on A and the mean momenta removed after each step."""
    return _edited(helical_rundir(d, nt=nt), [
        ("run.in", "&hydro_run_pars\n/\n",
         "&hydro_run_pars\n  omega=1., lremove_mean_momenta=T\n/\n"
         "&shear_run_pars\n  qshear=1.5, lshearadvection_as_shift=T\n/\n"),
        ("run.in", "&density_run_pars\n/\n",
         "&density_run_pars\n  diffrho_hyper3_mesh=5.\n/\n"),
        ("run.in", "  eta=5e-3", "  eta=5e-3, iresistivity='eta-const',"
         "'hyper3', eta_hyper3=5e-5"),
        ("run.in", "nu=5e-3, ivisc='nu-const'",
         "nu=5e-3, nu_hyper3_mesh=5., ivisc='nu-const','hyper3-mesh'")])


RUNDIRS = {"helical": (helical_rundir, HELICAL_N, "flagship"),
           "conv": (conv_rundir, CONV_N, "conv_slab")}


# ---- the namelist parser -------------------------------------------------------
CORPUS = [
    "&init_pars\n  xyz0=-3.1416,-3.1416,-3.1416, lperi=T,T,F\n/\n",
    "&hydro_init_pars\n inituu='gaussian-noise', ampluu=1e-3 ! noise\n/\n",
    "&run_pars\n nt=10, it1=2, dsnap=1.d-1, random_gen='nr_f90'\n/\n",
    "&entropy_run_pars\n iheatcond='K-const','chi-const', hcond0=8e-3\n/\n",
    "&init_pars\n bcz = 's','s','a','a2','c1:cT', fbcz1=5*0., fbcz2=0.,0.,"
    "0.,0.,1.\n/\n",
    "&magnetic_init_pars\n initaa='Ax=cosysinz', amplaa(2)=1e-3, "
    "kz_aa(1)=2.\n/\n",
    "&forcing_run_pars\n iforce='helical', force=.07, relhel=-1.,"
    " lscale_kvector_tobox=.true.\n/\n",
    "&viscosity_run_pars\n ivisc='nu-const','hyper3-simplified', "
    "nu=5e-3, nu_hyper3=1.e-10\n/\n&shear_run_pars\n qshear=1.5\n/\n",
    "&init_pars\n cvsid='$Id: start.in,v 1.1 2020/01/01 x $'\n"
    " unit_system='cgs', unit_length=3.08d21, lfix_unit_std=F\n/\n",
    "&density_init_pars\n initlnrho='piecew-poly', widthlnrho=0.05,\n"
    " ldensity_nolog=F\n/\n&eos_init_pars\n/\n",
]


@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_namelist_parsing_matches_jax(text):
    assert parse_namelists(text) == jax_parse(text)


# ---- the random streams ----------------------------------------------------------
def _state(r):
    return (r.s1, r.s2) if hasattr(r, "s1") else r.s


GENERATORS = {
    "mars_start": lambda m, s: m.start_seed(s, 0),
    "mars_rank3": lambda m, s: m.start_seed(s, 3),
    "mars_init": lambda m, s: m.MarsRan(s),
    "ran0_start": lambda m, s: m.Ran0(-((s - 1812 + 1) * 10)),
    "ran0_seed": lambda m, s: m.Ran0(s),
}


@pytest.mark.parametrize("seed", (1812, 1813, 4242))
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_streams_match_the_scalar_code(gen, seed, monkeypatch):
    """draw, next after draw and the state after each, gaunoise_vect of 1
    and 3 components and the forcing sequence: bit for bit against the JAX
    scalar code, with the lane blocks small enough to be crossed."""
    monkeypatch.setattr(trng, "_BLOCK", 997)
    a, b = GENERATORS[gen](jrng, seed), GENERATORS[gen](trng, seed)
    for n in (0, 1, 7, 2500):
        x, y = a.draw(n), b.draw(n)
        assert np.array_equal(x.view(np.uint32), y.view(np.uint32)), n
        assert _state(a) == _state(b)
        assert a.next() == b.next() and _state(a) == _state(b)
    for ncomp in (1, 3):
        x = jrng.gaunoise_vect(a, 1e-3, 14, 11, 9, ncomp)
        y = trng.gaunoise_vect(b, 1e-3, 14, 11, 9, ncomp)
        assert x.shape == y.shape == (ncomp, 14, 11, 9)
        assert np.array_equal(x.view(np.uint32), y.view(np.uint32))
        assert _state(a) == _state(b)
    kk = shell_vectors(3.0, 0.5)
    want = jrng.forcing_hel_sequence(a, 9, kk[:, 0], kk[:, 1], kk[:, 2])
    got = trng.forcing_hel_sequence(b, 9, kk[:, 0], kk[:, 1], kk[:, 2])
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert _state(a) == _state(b)


def test_k_dat_reads_as_jax_reads_it(tmp_path):
    d = helical_rundir(tmp_path / "r")
    want = jrng.read_k_dat(os.path.join(d, "k.dat"))
    got = trng.read_k_dat(os.path.join(d, "k.dat"))
    assert got[:2] == want[:2]
    assert all(np.array_equal(g, w) for g, w in zip(got[2:], want[2:]))


# ---- the loader ---------------------------------------------------------------------
def _unreplayed(cfg):
    """``cfg`` with its Forcing out of replay mode."""
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, sequence=None, kav=0.0)
        if m.name == "forcing" else m for m in cfg.modules))


def _by_name(modules):
    return sorted(modules, key=lambda m: m.name)


@pytest.mark.parametrize("name", sorted(RUNDIRS))
def test_loader_matches_jax_and_the_configs(tmp_path, name):
    """The same modules with the same shared fields, BCs, TimeSpec, grid,
    info and replayed fields as the JAX loader; the configuration of
    ``configs`` (the port's with fused=True; JAX's fields shared with it)
    once the forcing's replay fields are set aside."""
    write, n, config_fn = RUNDIRS[name]
    d = write(tmp_path / name)
    cfg, info = load_rundir(d)
    jcfg, jinfo = jax_load(d)
    assert cfg.fused and not jcfg.fused
    assert cfg.grid == pt.GridSpec(**dataclasses.asdict(jcfg.grid))
    assert cfg.time == pt.TimeSpec(**dataclasses.asdict(jcfg.time))
    assert [type(m).__name__ for m in cfg.modules] == \
        [type(m).__name__ for m in jcfg.modules]
    for mine, ref in zip(cfg.modules, jcfg.modules):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), \
                (mine.name, f.name)
    for axis in ("bcx", "bcy", "bcz"):
        assert [dataclasses.astuple(b) for b in getattr(cfg, axis)] == \
            [dataclasses.astuple(b) for b in getattr(jcfg, axis)]
    assert info.keys() == jinfo.keys()
    for k in info:
        if k != "init_overrides":
            assert info[k] == jinfo[k], k
    over, jover = info["init_overrides"], jinfo["init_overrides"]
    assert over.keys() == jover.keys() and over
    for k in over:
        assert over[k].dtype == np.float32
        assert np.array_equal(over[k], jover[k]), k
    forcing = cfg.module("forcing")
    if forcing is not None:
        assert forcing.sequence == jcfg.module("forcing").sequence
        assert len(forcing.sequence) == info["nt"]
    want = getattr(pt.configs, config_fn)(n)
    got = _unreplayed(cfg)
    assert got.replace(modules=()) == want.replace(modules=())
    assert _by_name(got.modules) == _by_name(want.modules)
    jwant = getattr(pt.configs, config_fn)(n, fused=False, pkg=pj)
    for mine, ref in zip(_by_name(got.modules), _by_name(jwant.modules)):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name)


@pytest.mark.parametrize("name", ("bext", "fcont"))
def test_loader_maps_b_ext_and_fcont_as_jax(tmp_path, name):
    """b_ext and lforcing_cont map as JAX's loader maps them
    (pencil_tpu/compat/rundir.py:1475-1550, :1569-1576): every field of
    the port's Magnetic and Forcing equal to the JAX module's, the 'xz'
    box from the grid."""
    d = {"bext": bext_rundir, "fcont": fcont_rundir}[name](tmp_path / "r")
    cfg, _ = load_rundir(d)
    jcfg, _ = jax_load(d)
    for mod in ("magnetic", "forcing"):
        mine, ref = cfg.module(mod), jcfg.module(mod)
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), \
                (mod, f.name)
    if name == "bext":
        assert cfg.module("magnetic").B_ext == (0.0, 0.0, 0.1)
    else:
        forcing = cfg.module("forcing")
        assert forcing.fcont_live() and forcing.force == 0.0
        gs = cfg.grid
        assert forcing.fcont_box == (gs.x0, gs.x0 + gs.Lx, gs.z0,
                                     gs.z0 + gs.Lz)


@pytest.mark.parametrize("name", ("upwind", "shock"))
def test_loader_maps_upwinding_and_shock_diffusion_as_jax(tmp_path, name):
    """lupw_lnrho, lupw_uu, lupw_ss and diffrho_shock, eta_shock (with
    iresistivity 'eta-shock') and chi_shock (with iheatcond 'shock') map
    as JAX's loader maps them (pencil_tpu/compat/rundir.py:720-724, :953,
    :1199-1205, :1509-1518): every field the two modules share equal."""
    d = {"upwind": upwind_rundir, "shock": shock_rundir}[name](tmp_path / "r")
    cfg, _ = load_rundir(d)
    jcfg, _ = jax_load(d)
    mods = ("density", "hydro", "entropy", "magnetic", "viscosity")
    for mod in mods:
        mine, ref = cfg.module(mod), jcfg.module(mod)
        assert (mine is None) == (ref is None), mod
        for f in dataclasses.fields(mine) if mine is not None else ():
            assert getattr(mine, f.name) == getattr(ref, f.name), \
                (mod, f.name)
    den, hyd, ent = (cfg.module(m) for m in ("density", "hydro", "entropy"))
    if name == "upwind":
        assert den.lupw_lnrho and hyd.lupw_uu and ent.lupw_ss
        assert pt.Model(cfg, device="cpu").mode == "zghost"
    else:
        assert den.diffrho_shock == cfg.module("magnetic").eta_shock \
            == ent.chi_shock == 1.0 and "shock" in ent.iheatcond
        assert cfg.module("shock") is not None
        assert pt.Model(cfg, device="cpu").mode == "wrap_aux"


# Entropy's other conduction and cooling options: the &entropy_run_pars
# values (in place of conv-slab's iheatcond and hcond0) and what each
# maps to beyond JAX's loader's field names
HEATCOND_MAPPED = {
    "kramers": "iheatcond='kramers', hcond0_kramers=1.7e-3, nkramers=0.5, "
               "chimax_kramers=2e-2, chimin_kramers=1e-3, ",
    "K-profile": "iheatcond='K-profile', hcond0=8e-3, ",
    "chi-cspeed": "iheatcond='chi-cspeed', chi=4e-3, chi_cspeed=0.4, ",
    "chi-therm": "iheatcond='chi-therm', chi=4e-3, ",
    "cooling": "iheatcond='K-const', hcond0=8e-3, tau_cool=3., "
               "TTref_cool=1.2, heat_uniform=1e-2, cool_uniform=2e-3, "
               "cooling_profile='step2', zcool=0.1, ",
    "step": "iheatcond='K-const', hcond0=8e-3, cooling_profile='step', ",
    "cubic_step": "iheatcond='K-const', hcond0=8e-3, "
                  "cooling_profile='cubic_step', ",
    "lin-z": "iheatcond='K-const', hcond0=8e-3, cooling_profile='lin-z', ",
    # the flux walls' fields, and the mixing-length flux, from which JAX's
    # loader derives hcond0 and Fbot
    "flux_walls": "iheatcond='K-const', hcond0=8e-3, chi_t=1e-3, "
                  "chit_prof1=0.5, chit_prof2=2., Fbot=0.02, Ftop=0.01, ",
    "mixinglength": "iheatcond='K-const', mixinglength_flux=1e-2, ",
}


@pytest.mark.parametrize("case", sorted(HEATCOND_MAPPED))
def test_loader_maps_the_heat_conduction_as_jax(tmp_path, case):
    """iheatcond 'kramers', 'K-profile', 'chi-cspeed' and 'chi-therm',
    hcond0_kramers, nkramers, chimax_kramers, chimin_kramers,
    chi_cspeed, tau_cool, TTref_cool, heat_uniform, cool_uniform and the
    cooling profiles map as JAX's loader maps them
    (pencil_tpu/compat/rundir.py:1196-1240): every field the two Entropy
    modules share equal; the run takes the zghost chain."""
    d = _edited(conv_rundir(tmp_path / "r"), [
        ("run.in", "iheatcond='K-const', hcond0=8e-3, ",
         HEATCOND_MAPPED[case])])
    cfg, _ = load_rundir(d)
    jcfg, _ = jax_load(d)
    mine, ref = cfg.module("entropy"), jcfg.module("entropy")
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert mine.iheatcond == (HEATCOND_MAPPED[case].split("'")[1],)
    assert pt.Model(cfg, device="cpu").mode == "zghost"


# Entropy's hyper-diffusion and cooling, which the loader once refused
# (the first two) or the card did outside the z-walled builds (the third):
# the &entropy_run_pars values added to conv-slab's
CHI_HYPER3_MAPPED = {
    "chi_hyper3": "iheatcond='K-const','hyper3', chi_hyper3=1.5e-7, ",
    "chi_hyper3_mesh": "iheatcond='K-const','hyper3-mesh', "
                       "chi_hyper3_mesh=5., ",
    "tau_cool": "iheatcond='K-const', tau_cool=2., TTref_cool=1.5, ",
}


@pytest.mark.parametrize("case", sorted(CHI_HYPER3_MAPPED))
def test_loader_maps_the_entropy_hyper3_as_jax(tmp_path, case):
    """chi_hyper3, chi_hyper3_mesh (with the flavours' names in
    iheatcond) and tau_cool map as JAX's loader maps them
    (pencil_tpu/compat/rundir.py:1200-1204): every field the two Entropy
    modules share equal; the run takes the zghost chain, on its H3
    instances where a del6 of s is on."""
    d = _edited(conv_rundir(tmp_path / "r"), [
        ("run.in", "iheatcond='K-const', ", CHI_HYPER3_MAPPED[case])])
    cfg, _ = load_rundir(d)
    jcfg, _ = jax_load(d)
    mine, ref = cfg.module("entropy"), jcfg.module("entropy")
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode == "zghost"
    assert fr.zg_kernels(pm)[0].endswith("_h3") == (case != "tau_cool")


# Viscosity's flavours and Density's diffrho the loader once refused: the
# run.in edits of the helical directory
VISC_MAPPED = {
    "diffrho": [("run.in", "ivisc='nu-const'", "ivisc='rho-nu-const'"),
                ("run.in", "&density_run_pars\n/\n",
                 "&density_run_pars\n  diffrho=1e-3\n/\n")],
    "cdiffrho": [("run.in", "&density_run_pars\n/\n",
                  "&density_run_pars\n  cdiffrho=2e-3\n/\n")],
    "zeta": [("run.in", "nu=5e-3,", "nu=5e-3, zeta=1e-3,"),
             ("run.in", "ivisc='nu-const'",
              "ivisc='nu-const','rho-nu-const-bulk'")],
    "nu_therm": [("run.in", "ivisc='nu-const'",
                  "ivisc='nu-therm', nu_cspeed=0.3")],
    "aniso": [("run.in", "ivisc='nu-const'",
               "ivisc='nu-simplified','hyper3_nu-const_aniso', "
               "nu_aniso_hyper3=1e-6,1e-6,5e-7")],
}


@pytest.mark.parametrize("case", sorted(VISC_MAPPED))
def test_loader_maps_the_viscosity_flavours_as_jax(tmp_path, case):
    """ivisc's flavours with zeta, nu_cspeed and nu_aniso_hyper3, and
    diffrho (cdiffrho where it is not given), load as JAX's loader loads
    them (pencil_tpu/compat/rundir.py:723, :1265-1274): every field the
    two modules share equal but ν₃ᵐ (the port reads it, JAX's loader
    keeps its default)."""
    d = _edited(helical_rundir(tmp_path / "r"), VISC_MAPPED[case])
    cfg, _ = load_rundir(d)
    jcfg, _ = jax_load(d)
    for name in ("viscosity", "density"):
        mine, ref = cfg.module(name), jcfg.module(name)
        for f in dataclasses.fields(mine):
            if f.name != "nu_hyper3_mesh" and hasattr(ref, f.name):
                assert getattr(mine, f.name) == getattr(ref, f.name), \
                    (name, f.name)
    assert cfg.module("density").diffrho == {
        "diffrho": 1e-3, "cdiffrho": 2e-3}.get(case, 0.0)
    assert pt.Model(cfg, device="cpu") is not None


# z-wall codes and the values the loader gives them: (run.in edits)
WALLS_MAPPED = {
    "ism": [("run.in", "bcz='s','s','a','a2','c1:cT'",
             "bcz='s','s','a','ism','ism', density_scale_factor=0.7")],
    "ism_unit_length": [("run.in", "bcz='s','s','a','a2','c1:cT'",
                         "bcz='s','s','a','ism','c1:cT'")],
    "sigmaSBt": [("run.in", "bcz='s','s','a','a2','c1:cT'",
                  "bcz='s','s','a','a2:hs','c1:Fgs', sigmaSBt=4.8e-3")],
    "zoo": [("run.in", "bcz='s','s','a','a2','c1:cT'",
             "bcz='der:e2','s0d:1s','out:ubs','a2:cdz','sT:ce'")],
}


@pytest.mark.parametrize("case", sorted(WALLS_MAPPED))
def test_loader_maps_the_wall_codes_as_jax(tmp_path, case):
    """The z-wall codes that the port fills, with their values ('ism':
    density_scale_factor, or 900 pc over unit_length) and σ_SBt, load as
    JAX's loader loads them (pencil_tpu/compat/rundir.py:1224-1233,
    :2380-2406); the run takes the zghost chain."""
    d = _edited(conv_rundir(tmp_path / "r"), WALLS_MAPPED[case])
    cfg, _ = load_rundir(d)
    jcfg, _ = jax_load(d)
    assert [(b.comp, b.low, b.high, b.lval, b.hval) for b in cfg.bcz] \
        == [(b.comp, b.low, b.high, b.lval, b.hval) for b in jcfg.bcz]
    assert cfg.module("entropy").sigmaSBt \
        == jcfg.module("entropy").sigmaSBt
    assert pt.Model(cfg, device="cpu").mode == "zghost"


# the switches of &shock_run_pars (appended to run.in) and the Shock
# module's fields they set
SHOCK_SWITCHES = {
    "ishock_max": ("ishock_max=3", dict(ishock_max=3)),
    "lgaussian_smooth": ("lgaussian_smooth=T", dict(lgaussian_smooth=True)),
    "lconvergence_only": ("lconvergence_only=F",
                          dict(lconvergence_only=False)),
    "shock_div_pow": ("shock_div_pow=2.", dict(shock_div_pow=2.0)),
}


@pytest.mark.parametrize("switch", sorted(SHOCK_SWITCHES))
@pytest.mark.parametrize("slot", ("shock", "shock_highorder"))
def test_loader_maps_the_shock_switches_as_jax(tmp_path, switch, slot):
    """SHOCK = shock or shock_highorder and each switch of
    &shock_run_pars map as JAX's loader maps them
    (pencil_tpu/compat/rundir.py:1635-1650): the two Shock modules equal
    field by field."""
    text, want = SHOCK_SWITCHES[switch]
    d = _edited(shock_rundir(tmp_path / "r"), [
        ("src/Makefile.local", "SHOCK = shock", f"SHOCK = {slot}"),
        ("run.in", "&density_run_pars\n",
         f"&shock_run_pars\n  {text}\n/\n&density_run_pars\n")])
    mine, ref = (load(d)[0].module("shock") for load in (load_rundir,
                                                         jax_load))
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    variant = "highorder" if slot == "shock_highorder" else "original"
    assert mine == pt.Shock(variant=variant, **want)


def test_loader_maps_lmax_shock(tmp_path):
    """&shock_run_pars' lmax_shock maps to the Shock module's (the JAX
    loader leaves it at its default, True)."""
    d = _edited(shock_rundir(tmp_path / "r"), [
        ("run.in", "&density_run_pars\n",
         "&shock_run_pars\n  lmax_shock=F\n/\n&density_run_pars\n")])
    assert load_rundir(d)[0].module("shock") == pt.Shock(lmax_shock=False)
    assert jax_load(d)[0].module("shock").lmax_shock


def test_loader_takes_a_walled_shock_with_its_bc(tmp_path):
    """A z-walled conv-slab directory with the Shock module: the slot's
    bcz code comes through as any other slot's, as in JAX's loader, and
    the configuration runs the zghost chain on K6k/K7k; without the code
    the port refuses the directory, naming the slot."""
    d = conv_shock_rundir(tmp_path / "r")
    cfg, _ = load_rundir(d)
    jcfg, _ = jax_load(d)
    assert pt.BC("shock", "s", "s") in cfg.bcz
    assert [(bc.comp, bc.low, bc.high) for bc in cfg.bcz] == [
        (bc.comp, bc.low, bc.high) for bc in jcfg.bcz]
    assert cfg.module("viscosity").coefficients()[1] == 1.0
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode == "zghost"
    assert fr.zg_kernels(pm) == ("rhs_zg_shock", "rhs_zg_upd_shock")
    bare = _edited(conv_shock_rundir(tmp_path / "s"), [
        ("start.in", ",'s'\n", "\n"), ("run.in", ",'s'\n", "\n")])
    with pytest.raises(NotImplementedError, match="'shock' slot"):
        pt.Model(load_rundir(bare)[0], device="cpu")


def test_replay_keeps_the_continuous_forcing(tmp_path):
    """A run directory with the reference's forcing draws (k.dat) and
    continuous forcing replays the draws and keeps the continuous term;
    JAX's replay rebuilds Forcing without it (ROADMAP Queue 3), so the
    port's module is held to JAX's loaded one field by field but for
    those."""
    d = _edited(helical_rundir(tmp_path / "r"), [(
        "run.in", "relhel=1., kf=3.",
        "relhel=1., kf=3., lforcing_cont=T, iforcing_cont='ABC',"
        " ampl_ff=0.1")])
    mine = load_rundir(d)[0].module("forcing")
    ref = jax_load(d)[0].module("forcing")
    assert mine.sequence is not None and mine.sequence == ref.sequence
    assert mine.lforcing_cont and mine.iforcing_cont == "ABC"
    assert not ref.lforcing_cont            # the reference's fault
    cont = ("lforcing_cont", "iforcing_cont", "ampl_ff", "fcont_box")
    for f in dataclasses.fields(mine):
        if f.name not in cont:
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name


def test_unmapped_groups_as_jax(tmp_path):
    d = helical_rundir(tmp_path / "r")
    with open(os.path.join(d, "run.in"), "a") as f:
        f.write("&power_spectrum_run_pars\n  lintegrate_shell=T\n/\n")
    assert load_rundir(d)[1]["unmapped_groups"] == \
        jax_load(d)[1]["unmapped_groups"] == ["power_spectrum_run_pars"]


def test_double_precision_runs_in_float32(tmp_path, capsys):
    d = conv_rundir(tmp_path / "r")
    with open(os.path.join(d, "src", "Makefile.local"), "a") as f:
        f.write("REAL_PRECISION = double\n")
    cfg, info = load_rundir(d)
    assert cfg.dtype == "float32" and "float32" in info["real_precision"]
    assert capsys.readouterr().err.count("REAL_PRECISION = double") == 1


# everything the port lacks: (run directory, file, text appended or
# (old, new) replaced, what the message names)
REFUSED = {
    # Makefile.local slots
    "particles": ("helical", "src/Makefile.local",
                  "PARTICLES = particles_dust\n", "PARTICLES"),
    "chemistry": ("helical", "src/Makefile.local",
                  "CHEMISTRY = chemistry\n", "CHEMISTRY"),
    "radiation": ("conv", "src/Makefile.local",
                  "RADIATION = radiation_ray\n", "RADIATION"),
    "special": ("helical", "src/Makefile.local",
                "SPECIAL = special/shell\n", "SPECIAL"),
    "initial_condition": ("helical", "src/Makefile.local",
                          "INITIAL_CONDITION = initial_condition/"
                          "kelvin_helmholtz\n", "INITIAL_CONDITION"),
    "eos_ionization": ("conv", "src/Makefile.local",
                       "EOS = eos_ionization\n", "EOS"),
    "hydro_kinematic": ("helical", "src/Makefile.local",
                        ("HYDRO = hydro", "HYDRO = hydro_kinematic"),
                        "HYDRO"),
    "bfield": ("helical", "src/Makefile.local",
               ("MAGNETIC = magnetic", "MAGNETIC = bfield"), "MAGNETIC"),
    "boussinesq": ("conv", "src/Makefile.local",
                   ("DENSITY = density", "DENSITY = experimental/boussinesq"),
                   "DENSITY"),
    "gravity_r": ("conv", "src/Makefile.local",
                  ("GRAVITY = gravity_simple", "GRAVITY = gravity_r"),
                  "GRAVITY"),
    "temperature": ("conv", "src/Makefile.local",
                    ("ENTROPY = entropy", "ENTROPY = temperature_idealgas"),
                    "ENTROPY"),
    "deriv_8th": ("helical", "src/Makefile.local", "DERIV = deriv_8th\n",
                  "DERIV"),
    # namelist groups of modules the port lacks
    "pscalar_group": ("helical", "start.in",
                      "&pscalar_init_pars\n  initlncc='gaussian'\n/\n",
                      "pscalar"),
    "particles_group": ("helical", "start.in",
                        "&particles_init_pars\n  initxxp='random'\n/\n",
                        "particles"),
    "dust_group": ("helical", "run.in",
                   "&dustvelocity_run_pars\n  nud=1e-3\n/\n", "dustvelocity"),
    "testfield_group": ("helical", "run.in",
                        "&testfield_run_pars\n  etatest=1e-3\n/\n",
                        "testfield"),
    "initial_condition_group": ("helical", "start.in",
                                "&initial_condition_pars\n  ampl=1.\n/\n",
                                "initial_condition_pars"),
    "mean_field_group": ("helical", "run.in",
                         "&magn_mf_run_pars\n  alpha_effect=1.\n/\n",
                         "magn_mf"),
    # values the port's modules do not take
    "iheatcond": ("conv", "run.in",
                  ("iheatcond='K-const'", "iheatcond='chit'"),
                  "iheatcond"),
    # Entropy's options that stay out: the hcond table of 'K-profile', the
    # entropy-fluctuation diffusion and the star-in-a-box cooling
    "lread_hcond": ("conv", "run.in", ("cs2cool=1.", "cs2cool=1., "
                                       "lread_hcond=T"), "lread_hcond"),
    "lchit_fluct": ("conv", "run.in", ("cs2cool=1.", "cs2cool=1., "
                                       "lchit_fluct=T"), "lchit_fluct"),
    "cooltype": ("conv", "run.in", ("cs2cool=1.", "cs2cool=1., "
                                    "cooltype='shell'"), "cooltype"),
    "lthdiff_hmax": ("conv", "run.in", ("cs2cool=1.", "cs2cool=1., "
                                        "lthdiff_Hmax=T"), "lthdiff_hmax"),
    "cooling_profile": ("conv", "run.in",
                        ("cs2cool=1.", "cs2cool=1., cooling_profile='tanh'"),
                        "cooling_profile"),
    "sinh_grid": ("conv", "start.in",
                  ("lperi=T,T,F", "lperi=T,T,F, grid_func='linear',"
                   "'linear','sinh'"), "grid_func"),
    "spherical": ("helical", "start.in",
                  ("random_gen='nr_f90'",
                   "random_gen='nr_f90', coord_system='spherical'"),
                  "coord_system"),
    "nonperiodic_x": ("conv", "start.in", ("lperi=T,T,F", "lperi=F,T,F"),
                      "lperi"),
    "freeze_zones": ("conv", "run.in",
                     ("nt=6,", "lfreeze_varint=T,T,T,T,T, nt=6,"),
                     "lfreeze_varint"),
    "itorder_5": ("helical", "run.in", ("itorder=3", "itorder=5"),
                  "itorder"),
    "density_nolog": ("conv", "start.in",
                      ("initlnrho='piecew-poly'",
                       "initlnrho='piecew-poly', ldensity_nolog=T"),
                      "ldensity_nolog"),
    "init_uu": ("helical", "start.in",
                ("inituu='gaussian-noise'", "inituu='sinwave-x'"), "inituu"),
    "init_ss": ("conv", "start.in",
                ("initss='piecew-poly'", "initss='isothermal'"), "initss"),
    "ivisc": ("helical", "run.in", ("ivisc='nu-const'",
                                    "ivisc='nu-const','nu-mixture'"),
              "nu-mixture"),
    "iforce": ("helical", "run.in", ("iforce='helical'", "iforce='irrot'"),
               "iforce"),
    "bc_mnemonic": ("conv", "run.in", ("'c1:cT'", "'c1:c3'"), "c3"),
    "iresistivity": ("helical", "run.in",
                     ("eta=5e-3", "eta=5e-3, iresistivity='eta-zdep'"),
                     "iresistivity"),
    "weno": ("helical", "run.in", ("itorder=3", "itorder=3, "
                                   "lweno_transport=T"), "lweno_transport"),
    "mu0": ("helical", "start.in",
            ("random_gen='nr_f90'", "random_gen='nr_f90', "
             "unit_velocity=1e5, unit_density=1e-24"), "mu0"),
    "gravx_profile": ("conv", "start.in",
                      ("gravz=-1.,", "gravz=-1., gravx_profile='linear',"),
                      "gravx_profile"),
    "cylinder_in_a_box": ("helical", "start.in",
                          ("random_gen='nr_f90'", "random_gen='nr_f90', "
                           "lcylinder_in_a_box=T"), "lcylinder_in_a_box"),
    # the polar hyper-diffusion of s needs curvilinear coordinates
    "chi_hyper3_polar": ("conv", "run.in",
                         ("iheatcond='K-const', ",
                          "iheatcond='K-const','hyper3-sph', "
                          "chi_hyper3=1e-6, "), "hyper3-sph"),
    "beta_glnrho_global": ("helical", "start.in",
                           ("&density_init_pars\n/\n",
                            "&density_init_pars\n  beta_glnrho_global="
                            "-0.1,0.,0.\n/\n"), "beta_glnrho_global"),
    "fargo": ("helical", "run.in", ("itorder=3", "itorder=3, "
                                    "lfargo_advection=T"),
              "lfargo_advection"),
}


# the shearing box's options that the loader once refused: (the &shear
# group appended to run.in, the Shear that it maps to)
SHEAR_MAPPED = {
    "shear_as_shift": ("&shear_run_pars\n  qshear=1.5, "
                       "lshearadvection_as_shift=T\n/\n",
                       dict(qshear=1.5, lshearadvection_as_shift=True)),
    "sshear": ("&shear_run_pars\n  Sshear=-1.\n/\n",
               dict(Sshear=-1.0)),
}


@pytest.mark.parametrize("case", sorted(SHEAR_MAPPED))
def test_loader_maps_the_shear_options(tmp_path, case):
    """lshearadvection_as_shift and Sshear map onto the port's Shear (JAX
    rundir.py:1579-1587), and the run takes the shear build's chain."""
    d = helical_rundir(tmp_path / "r")
    text, want = SHEAR_MAPPED[case]
    with open(os.path.join(d, "run.in"), "a") as f:
        f.write(text)
    cfg, _ = load_rundir(d)
    shear = cfg.module("shear")
    for k, v in want.items():
        assert getattr(shear, k) == v, k
    assert shear.S == want.get("Sshear", -1.5)
    assert Model(cfg, device="cpu").mode == "zroll"


def test_loader_maps_the_mesh_and_the_mean_removal(tmp_path):
    """ivisc 'hyper3-mesh' with nu_hyper3_mesh (read, where JAX's loader
    keeps its default of 5: ROADMAP Queue 3), diffrho_hyper3_mesh and
    lremove_mean_momenta map onto the port's modules; the defaults are
    JAX's."""
    d = safi_rundir(tmp_path / "r")
    cfg, _ = load_rundir(d)
    visc, den = cfg.module("viscosity"), cfg.module("density")
    assert visc.ivisc == ("nu-const", "hyper3-mesh")
    assert visc.nu_hyper3_mesh == 5.0 and den.diffrho_hyper3_mesh == 5.0
    assert cfg.module("hydro").lremove_mean_momenta
    assert cfg.module("shear").lshearadvection_as_shift
    assert cfg.module("magnetic").eta_hyper3 == 5e-5
    with open(os.path.join(d, "run.in")) as f:
        text = f.read().replace("nu_hyper3_mesh=5.", "nu_hyper3_mesh=3.")
    with open(os.path.join(d, "run.in"), "w") as f:
        f.write(text)
    assert load_rundir(d)[0].module("viscosity").nu_hyper3_mesh == 3.0
    plain, _ = load_rundir(helical_rundir(tmp_path / "p"))
    assert plain.module("viscosity").nu_hyper3_mesh == 5.0
    assert plain.module("density").diffrho_hyper3_mesh == 0.0
    assert not plain.module("hydro").lremove_mean_momenta


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_name_what_they_refuse(tmp_path, case):
    which, fname, edit, what = REFUSED[case]
    d = RUNDIRS[which][0](tmp_path / "r")
    path = os.path.join(d, fname)
    with open(path) as f:
        text = f.read()
    if isinstance(edit, tuple):
        assert edit[0] in text
        text = text.replace(edit[0], edit[1])
    else:
        text += edit
    with open(path, "w") as f:
        f.write(text)
    with pytest.raises(NotImplementedError, match=what):
        load_rundir(d)


# ---- the replayed forcing kick ---------------------------------------------------
@pytest.mark.parametrize("it", (0, 3, 40))
@pytest.mark.parametrize("shear", (False, True), ids=("plain", "shear"))
def test_replay_kick_matches_jax(it, shear):
    """Row ``it`` of a sequence (40: past its end, the last row) kicks u as
    JAX's ``_replay`` does, with Shear's kx shift at t = 0.37 + dt and
    with k.dat vectors scaled to the box: within 1e-6 of the kick's max."""
    rng = np.random.default_rng(it)
    kk = shell_vectors(3.0, 0.5)
    seq = tuple((*kk[rng.integers(len(kk))], float(rng.uniform(-3, 3)),
                 float(rng.uniform(0, 6))) for _ in range(8))
    spec = dict(nx=8, ny=12, nz=16, Lx=2.0, Ly=3.0, Lz=4.0)
    kw = dict(force=0.07, kf=3.0, relhel=0.6, sequence=seq, kav=3.1,
              cs0eff=1.3, lscale_kvector_tobox=True)
    shear_kw = dict(qshear=1.5, Omega=0.8)
    uu = rng.standard_normal((3, 8, 12, 16)).astype(np.float32)
    t, dt = np.float32(0.37), np.float32(2.5e-2)
    jcfg = pj.Config(grid=pj.GridSpec(**spec), modules=(
        pj.Forcing(**kw), *((pj.Shear(**shear_kw),) if shear else ())))
    want = pj.Forcing(**kw)._replay(
        {"uu": uu}, jax_make_grid(jcfg.grid), jcfg, dt, np.int32(it),
        t=t + dt)["uu"]
    gs = pt.GridSpec(**spec)
    forcing = pt.Forcing(**kw)
    tables = forcing.tables(gs, "cpu",
                            shear=pt.Shear(**shear_kw) if shear else None)
    got = forcing.after_timestep(
        {"uu": torch.tensor(uu)}, make_grid(gs, "cpu"), tables,
        (torch.tensor(it, dtype=torch.int32), torch.tensor(t + dt)),
        torch.tensor(dt), None)["uu"].numpy()
    kick = np.asarray(want) - uu
    assert np.abs(kick).max() > 1e-4
    assert np.abs(got - np.asarray(want)).max() <= 1e-6 * np.abs(kick).max() \
        + 2 * np.spacing(np.abs(uu).max())


# ---- the var.dat codec ---------------------------------------------------------------
def test_codec_round_trip_and_plain_version(tmp_path):
    """The C++ codec and its plain version (numpy), each way: the same
    bytes written, the fields, time, coordinates and deltay read back bit
    for bit; the native build lands under pencil_tpu_torch/_build/."""
    assert io_dist.native_lib() is not None
    assert "_build" in str(io_dist._build_native())
    rng = np.random.default_rng(1)
    f = rng.standard_normal((5, 10, 11, 12)).astype(np.float32)
    x, y, z = (np.linspace(0, 1, m) for m in (10, 11, 12))
    dim = dict(mx=10, my=11, mz=12, mvar=5, maux=0, precision="S")
    args = (f, 0.25, x, y, z, 0.1, 0.2, 0.3, 0.7)
    io_dist.write_var(tmp_path / "native.dat", *args)
    io_dist.np_write_var(tmp_path / "plain.dat", *args)
    assert (tmp_path / "native.dat").read_bytes() == \
        (tmp_path / "plain.dat").read_bytes()
    for vf in (io_dist.read_var(tmp_path / "plain.dat", dim=dim),
               io_dist.np_read_var(tmp_path / "native.dat", 10, 11, 12, 5,
                                   np.float32)):
        assert np.array_equal(vf.f, f)
        assert vf.t == float(np.float32(0.25))
        assert np.array_equal(vf.x, x.astype(np.float32))
        assert vf.deltay == float(np.float32(0.7))


def test_read_var_of_an_exported_state(tmp_path):
    """post.read.var of the var.dat that export_state writes: the state's
    fields inside wrapped ghost zones, named by index.pro."""
    cfg = pt.configs.conv_slab(CONV_N)
    model = pt.Model(cfg, device="cpu")
    state = model.init_state(3)
    io_dist.export_state(model, state, tmp_path)
    v = pread.var("var.dat", tmp_path, trimall=True)
    assert v.t == float(state["t"])
    fa = model.reg.stack(state["fields"]).numpy()
    for i, name in enumerate(model.reg.comp_names):
        assert np.array_equal(getattr(v, name), fa[i]), name
    assert np.array_equal(v.z[3:-3], model.grid.z.numpy())
    assert np.array_equal(np.pad(fa, [(0, 0)] + [(3, 3)] * 3, mode="wrap"),
                          v.f)
    assert np.array_equal(pread.var("var.dat", tmp_path / "proc0").f, v.f)
