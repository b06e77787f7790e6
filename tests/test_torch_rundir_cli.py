"""``python -m pencil_tpu_torch start|run|export <rundir>`` on the CPU
against ``python -m pencil_tpu`` on a copy of the same run directory: the
two run directories of tests/test_torch_rundir.py (helical MHD turbulence
with the reference's forcing draws replayed, on the port's K1-K3 chain;
stratified convection on K6/K7) and two of the first one's shape, in an
imposed field (``B_ext``) and driven by continuous forcing ('ABC', the
helical kicks off), started and run by both command lines, and two the
loader refused before: the convection directory with lupw_lnrho,
lupw_uu and lupw_ss, and the first one's shape with ss and the shock
diffusivities beside nu-shock, with SHOCK = shock_highorder (ishock_max
= 2, 'gaussian' smoothing) too, and the convection directory with the
Shock module and nu-shock between its walls, the slot's bcz code 's',
and the first one's shape in a rotating shearing box with SAFI, the mesh
flavour of del6 and lremove_mean_momenta, and the convection directory
with Kramers opacity, Newtonian cooling and the 'cubic_step' cooling
profile, and with the del6 hyper-diffusion of s and Newtonian cooling
(started and run only),
the port's chain on its kernels' plain versions, the JAX package on its
jnp path (its loader's Config is not fused); the reference-layout data
directory that both ``export`` commands write; and RELOAD, which re-reads
run.in in the middle of a run.

Bounds: each field within 2e-5 × its max and dt within 1e-6 relative
(tests/test_fused.py); the rows of time_series.dat at the same steps, each
printed value equal to JAX's or one unit apart in its last printed digit.
The convection directory starts with velocity noise of 1e-2, not the
sample's 1e-3, whose velocity after a few steps is the residual of the O(1)
hydrostatic balance below its float32 floor (tests/test_torch_zghost.py,
UU_AMPL).
"""
import os
import shutil

import numpy as np
import pytest
import torch

from pencil_tpu.__main__ import main as jax_main
from pencil_tpu_torch.__main__ import main
from pencil_tpu_torch.compat import io_dist
from pencil_tpu_torch.compat.rundir import load_rundir
from pencil_tpu_torch.io.snapshot import load_snapshot
from pencil_tpu_torch.io.timeseries import read_time_series
from pencil_tpu_torch.model import Model
from pencil_tpu_torch.post import read as pread
from pencil_tpu_torch.run import Run, RunParams
from test_torch_rundir import (bext_rundir, chi_hyper3_rundir, conv_rundir,
                               conv_shock_rundir, fcont_rundir,
                               helical_rundir, kramers_rundir,
                               nu_therm_rundir, radiative_rundir,
                               safi_rundir, shock_rundir,
                               shock_highorder_rundir, upwind_rundir,
                               vacuum_rundir, visc_rundir)

torch.set_num_threads(1)

WRITERS = {"helical": lambda d: helical_rundir(d, nt=4),
           "conv": lambda d: conv_rundir(d, nt=4, uu_ampl="1e-2"),
           "bext": bext_rundir, "fcont": fcont_rundir}


@pytest.fixture(scope="module", params=sorted(WRITERS))
def both_runs(request, tmp_path_factory):
    """(port run directory, JAX run directory) after start, run and export
    through each command line."""
    base = tmp_path_factory.mktemp(request.param)
    mine = WRITERS[request.param](base / "port")
    ref = shutil.copytree(mine, base / "jax")
    for cmd in ("start", "run", "export"):
        main([cmd, mine, "--device", "cpu"])
        jax_main([cmd, str(ref)])
    return mine, str(ref)


def test_cli_state_matches_jax(both_runs):
    assert_states_match(*both_runs)


def assert_states_match(mine, ref, skip=()):
    """The final var.npz of the two run directories: it, t and dt, and
    every field but those of ``skip`` within 2e-5 × its max."""
    got = pread.var("var.npz", os.path.join(mine, "data"))
    with np.load(os.path.join(ref, "data", "var.npz")) as z:
        want = {k[6:]: z[k] for k in z.files if k.startswith("field_")}
        assert got.it == int(z["it"]) == 4
        assert abs(got.dt - float(z["dt"])) <= 1e-6 * float(z["dt"])
        assert abs(got.t - float(z["t"])) <= 1e-6 * float(z["t"])
    assert want.keys() == {k for k in vars(got) if k not in ("t", "dt",
                                                             "it")}
    for k, w in want.items():
        if k in skip:
            continue
        g = getattr(got, k)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max(), k


@pytest.mark.parametrize("name", ("upwind", "shock"))
def test_cli_runs_upwinding_and_shock_diffusion(tmp_path, name):
    """Run directories the loader refused before: conv-slab's shape with
    lupw_lnrho, lupw_uu and lupw_ss (the port's K6/K7 chain), and
    helical-MHDturb's shape with ss and the whole shock-capturing set,
    diffrho_shock, eta_shock and chi_shock beside nu-shock (the chain of
    K1se/K5wse), started and run by both command lines; the port's
    final state against JAX's jnp path (the stored shock slot left out:
    JAX's jnp path keeps its zeros there, ROADMAP Queue 3)."""
    mine = {"upwind": upwind_rundir, "shock": shock_rundir}[name](
        tmp_path / "port")
    ref = shutil.copytree(mine, tmp_path / "jax")
    for cmd in ("start", "run"):
        main([cmd, mine, "--device", "cpu"])
        jax_main([cmd, str(ref)])
    assert_states_match(mine, str(ref), skip=("shock",))


@pytest.mark.parametrize("name", ("highorder", "conv_shock"))
def test_cli_runs_the_shock_module_whole(tmp_path, name):
    """Run directories the loader refused before: helical-MHDturb's shape
    with the whole shock-capturing set and SHOCK = shock_highorder (the
    chain of K1se/K5wse, the 'highorder' profile in its pre-pass), and
    conv-slab's shape with SHOCK = shock, nu-shock and the slot's z BC
    's' (the chain of K6k/K7k), started and run by both command lines;
    the port's final state against JAX's jnp path (the stored shock slot
    left out, as above)."""
    mine = {"highorder": shock_highorder_rundir,
            "conv_shock": conv_shock_rundir}[name](tmp_path / "port")
    ref = shutil.copytree(mine, tmp_path / "jax")
    for cmd in ("start", "run"):
        main([cmd, mine, "--device", "cpu"])
        jax_main([cmd, str(ref)])
    assert_states_match(mine, str(ref), skip=("shock",))


def _last_digit(text):
    """One unit in the last printed digit of a Fortran number."""
    mant, _, exp = text.upper().partition("E")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (int(exp or 0) - decimals)


def test_cli_time_series_matches_jax(both_runs):
    mine, ref = both_runs
    lines = [open(os.path.join(d, "data", "time_series.dat")).read()
             .splitlines() for d in (mine, ref)]
    assert lines[0][0] == lines[1][0]              # the header
    assert len(lines[0]) == len(lines[1]) == 5     # it = 0, 1, 2, 4
    for row, jrow in zip(lines[0][1:], lines[1][1:]):
        for g, w in zip(row.split(), jrow.split()):
            assert abs(float(g) - float(w)) <= _last_digit(w) * 1.0001, \
                (row, jrow)
    got, want = (read_time_series(os.path.join(d, "data", "time_series.dat"))
                 for d in (mine, ref))
    assert list(got) == list(want) and len(got) >= 6


def test_cli_export_matches_jax(both_runs):
    """dim.dat, index.pro and param.nml as JAX writes them; the var.dat
    read back (the C++ codec and numpy) equal to the port's own final
    state."""
    mine, ref = both_runs
    for name in ("dim.dat", "index.pro", "param.nml", "proc0/dim.dat",
                 "proc0/proc0/dim.dat"):
        assert open(os.path.join(mine, "data", name)).read() == \
            open(os.path.join(ref, "data", name)).read(), name
    cfg, _ = load_rundir(mine)
    model = Model(cfg, device="cpu")
    state = load_snapshot(os.path.join(mine, "data", "var.npz"), model)
    fa = model.reg.stack(state["fields"]).numpy()
    path = os.path.join(mine, "data", "proc0", "var.dat")
    vf = io_dist.read_var(path)
    plain = io_dist.np_read_var(path, *vf.f.shape[1:], vf.f.shape[0],
                                np.float32)
    for v in (vf, plain):
        assert np.array_equal(v.f[:, 3:-3, 3:-3, 3:-3], fa)
        assert v.t == float(state["t"])
    jvf = io_dist.read_var(os.path.join(ref, "data", "proc0", "var.dat"))
    assert vf.f.shape == jvf.f.shape
    for a in ("x", "y", "z"):
        assert np.array_equal(getattr(vf, a), getattr(jvf, a)), a


def test_cli_refuses_a_sharded_run_and_the_card_without_one(tmp_path):
    d = helical_rundir(tmp_path / "r")
    with pytest.raises(NotImplementedError, match="sharded"):
        main(["run", d, "--sharded", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["start", d])


def _reload_rundir(d):
    os.makedirs(os.path.join(d, "src"))
    with open(os.path.join(d, "start.in"), "w") as f:
        f.write("&init_pars\n/\n&eos_init_pars\n gamma=1.0001\n/\n"
                "&density_init_pars\n/\n&hydro_init_pars\n "
                "inituu='gaussian-noise', ampluu=1e-2\n/\n")
    with open(os.path.join(d, "src", "cparam.local"), "w") as f:
        f.write("integer, parameter :: nxgrid=8,nygrid=8,nzgrid=8\n")


RELOADED = {
    "viscosity": ("&viscosity_run_pars\n ivisc='nu-const', nu=8e-3\n/\n",
                  8e-3),
    # a new field: the slot set changes and the old model stays
    "new_slot": ("&viscosity_run_pars\n ivisc='nu-const', nu=2e-3\n/\n"
                 "&magnetic_run_pars\n eta=1e-3\n/\n", 2e-3),
}


@pytest.mark.parametrize("case", sorted(RELOADED))
def test_reload_control_file(tmp_path, case):
    """RELOAD with a rundir rebuilds the step without losing state
    (after tests/test_aux_subsystems.py:67)."""
    rundir = str(tmp_path / "run")
    _reload_rundir(rundir)
    with open(os.path.join(rundir, "run.in"), "w") as f:
        f.write("&run_pars\n nt=10, it1=5\n/\n&viscosity_run_pars\n "
                "ivisc='nu-const', nu=2e-3\n/\n")
    cfg, info = load_rundir(rundir)
    model = Model(cfg, device="cpu")
    datadir = os.path.join(rundir, "data")
    run = Run(model, datadir=datadir, params=RunParams(nt=6, it1=3),
              rundir=rundir, quiet=True)
    state = model.init_state(0, overrides=info["init_overrides"])
    os.makedirs(datadir, exist_ok=True)
    text, nu = RELOADED[case]
    with open(os.path.join(rundir, "run.in"), "w") as f:
        f.write("&run_pars\n nt=10, it1=5\n/\n" + text)
    open(os.path.join(datadir, "RELOAD"), "w").close()
    state = run.main_loop(state)
    assert int(state["it"]) == 6
    assert not os.path.exists(os.path.join(datadir, "RELOAD"))
    assert run.model.cfg.module("viscosity").nu == nu
    assert (run.model is model) == (case == "new_slot")


def test_cli_runs_the_safi_shearing_box(tmp_path):
    """A run directory the loader refused before: helical-MHDturb's shape
    in a rotating shearing box with SAFI, 'hyper3-mesh' and
    diffrho_hyper3_mesh (η₃ on A) and lremove_mean_momenta, started and
    run by both command lines (the port's zroll chain with the shift
    between substeps; JAX's jnp path); the final states agree."""
    mine = safi_rundir(tmp_path / "port")
    ref = shutil.copytree(mine, tmp_path / "jax")
    for cmd in ("start", "run"):
        main([cmd, mine, "--device", "cpu"])
        jax_main([cmd, str(ref)])
    assert_states_match(mine, str(ref))


def test_cli_runs_kramers_conduction(tmp_path):
    """A run directory the loader refused before: conv-slab's shape with
    iheatcond 'kramers' (clipped), tau_cool and the 'cubic_step' cooling
    profile, started and run by both command lines (the port's K6/K7
    chain on their CHI instances' plain versions; JAX's jnp path); the
    final states agree."""
    mine = kramers_rundir(tmp_path / "port")
    ref = shutil.copytree(mine, tmp_path / "jax")
    for cmd in ("start", "run"):
        main([cmd, mine, "--device", "cpu"])
        jax_main([cmd, str(ref)])
    assert_states_match(mine, str(ref))


def test_cli_runs_the_hyper_diffusion_of_s(tmp_path):
    """A run directory the loader refused before: conv-slab's shape with
    chi_hyper3 ('hyper3' in iheatcond) and tau_cool, started and run by
    both command lines (the port's K6/K7 chain on their H3 instances'
    plain versions; JAX's jnp path); the final states agree."""
    mine = chi_hyper3_rundir(tmp_path / "port")
    ref = shutil.copytree(mine, tmp_path / "jax")
    assert load_rundir(mine)[0].module("entropy").chi_hyper3 > 0.0
    for cmd in ("start", "run"):
        main([cmd, mine, "--device", "cpu"])
        jax_main([cmd, str(ref)])
    assert_states_match(mine, str(ref))


@pytest.mark.parametrize("writer", (radiative_rundir, vacuum_rundir),
                         ids=("Fgs", "pot"))
def test_cli_runs_the_z_wall_codes(tmp_path, writer):
    """Two run directories the loader refused before: the Kramers
    conv-slab with a black-body top over a hydrostatic density top ('Fgs'
    with σ_SBt and χ_t, 'hs'), and magnetoconvection with a vacuum
    exterior ('pot' on A), started and run by both command lines (the
    port's K6/K7 chain, the second on the x/y-ghosted layout of its shear
    build's plain versions; JAX's jnp path); the final states agree."""
    mine = writer(tmp_path / "port")
    ref = shutil.copytree(mine, tmp_path / "jax")
    cfg = load_rundir(mine)[0]
    codes = {c for bc in cfg.bcz for c in (bc.low, bc.high)}
    assert codes & {"Fgs", "pot"}
    for cmd in ("start", "run"):
        main([cmd, mine, "--device", "cpu"])
        jax_main([cmd, str(ref)])
    assert_states_match(mine, str(ref))


def _diffrho_rundir(d):
    """The helical directory with 'rho-nu-const' in place of nu-const and
    Fickian mass diffusion D = ν (the flagship's path of the flavours)."""
    from test_torch_rundir import _edited
    return _edited(helical_rundir(d, nt=4), [
        ("run.in", "ivisc='nu-const'", "ivisc='rho-nu-const'"),
        ("run.in", "&density_run_pars\n/\n",
         "&density_run_pars\n  diffrho=5e-3\n/\n")])


@pytest.mark.parametrize("writer", (_diffrho_rundir, visc_rundir,
                                    nu_therm_rundir),
                         ids=("rho-nu-const diffrho", "bulk zeta",
                              "nu-therm"))
def test_cli_runs_the_viscosity_flavours(tmp_path, writer):
    """Three run directories the loader refused before: helical MHD with
    'rho-nu-const' and diffrho (the port's K1-K3 chain), the conv-slab with
    'rho-nu-const', the bulk ζ and diffrho, and the conv-slab with
    'nu-therm' (K6/K7), started and run by both command lines (the port's
    chains on their kernels' plain versions; JAX's jnp path); the final
    states agree."""
    mine = writer(tmp_path / "port")
    ref = shutil.copytree(mine, tmp_path / "jax")
    for cmd in ("start", "run"):
        main([cmd, mine, "--device", "cpu"])
        jax_main([cmd, str(ref)])
    assert_states_match(mine, str(ref))

