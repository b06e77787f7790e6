"""Steps of the two new paths under gravity in pencil_tpu_torch against
pencil_tpu: 3 steps of the vertically stratified shearing box with an
energy equation (``strat_box(n, entropy=True)``, MHD and hydro: the
port's zghost chain on the plain K6ms/K7ms and K6s/K7s, CHI instances)
and of forced stratified turbulence in a periodic box
(``strat_box(n, periodic=True, shear=False, forcing=0.05)``, MHD and
hydro: the wrap chain on the plain K1-K3 and K1h-K3h, kicked with JAX's
own draws through ``Model.forcing_draws``), each against the JAX fused
step and against the JAX jnp path.

The JAX fused side runs one tile over the whole domain (PC_TX = PC_CX =
nx, ROADMAP Queue 3).  Velocity and vector-potential noise is 1e-2 from
numpy with a seed (at the configuration's 1e-3 a velocity beside the O(1)
pressure and gravity forces sits near its float32 floor,
tests/test_torch_zghost.py); the sheared sets start at t = 0.37.
Bounds, those of tests/test_fused.py: each field within 2e-5 × its max,
dt within 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import strat_box
from test_torch_model import jax_forcing_draws
from test_torch_zghost_mhd import AA_AMPL, UU_AMPL, assert_states_close

torch.set_num_threads(1)

NSTEPS = 3
TSTART = 0.37
# each path: strat_box keyword arguments, and its chain
PATHS = {"ent": (dict(entropy=True), "zghost"),
         "ent_hydro": (dict(entropy=True, magnetic=False), "zghost"),
         "periodic": (dict(periodic=True, shear=False, forcing=0.05),
                      "wrap"),
         "periodic_hydro": (dict(periodic=True, shear=False, magnetic=False,
                                 forcing=0.05), "wrap")}


def path_cfg(pkg, shape, case, fused=True):
    cfg = strat_box(shape, pkg=pkg, fused=fused, **PATHS[case][0])
    if cfg.module("shear") is not None:
        cfg = cfg.replace(time=pkg.TimeSpec(itorder=3, tstart=TSTART))
    return cfg


def run_both(shape, case, jax_fused, seed, monkeypatch):
    """The JAX package (fused or jnp path) and the port's chain, NSTEPS
    steps from the JAX init (the hydrostatic lnρ and, with an entropy
    field, its ss) with u (and A) replaced by numpy noise; the forced ones
    kicked with the JAX step's draws."""
    if jax_fused:
        monkeypatch.setenv("PC_TX", str(shape[0]))
        monkeypatch.setenv("PC_CX", str(shape[0]))
    jm = pj.Model(path_cfg(pj, shape, case, fused=jax_fused))
    pm = pt.Model(path_cfg(pt, shape, case), device="cpu")
    assert pm.mode == PATHS[case][1]
    if jax_fused:
        shear = jm.cfg.module("shear")
        sdy = None if shear is None else shear.deltay(
            jm.cfg.time.tstart, jm.cfg.grid.Lx, jm.cfg.grid.Ly)
        assert jm._fused_mode(None, sdy, shape[2]) == PATHS[case][1]
    rng = np.random.default_rng(seed)
    over = {"uu": (UU_AMPL * rng.standard_normal((3,) + shape))
            .astype(np.float32)}
    if "aa" in pm.reg.slots:
        over["aa"] = (AA_AMPL * rng.standard_normal((3,) + shape)).astype(
            np.float32)
    js = jm.init_state(seed, overrides=over)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(seed, overrides=overrides_from_numpy(fields, pm.reg))
    if pm.forcing is not None:
        pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"],
                                                  NSTEPS)).__next__
    jstep, pstep = jm.make_step(), pm.make_step()
    for _ in range(NSTEPS):
        js, ps = jstep(js), pstep(ps)
    return js, ps


@pytest.mark.parametrize("case", PATHS)
def test_gravity_path_matches_jax_fused(case, monkeypatch):
    """The port's chain against the JAX fused step, 3 steps at 8×8×16."""
    assert_states_close(*run_both((8, 8, 16), case, True, 11, monkeypatch))


@pytest.mark.parametrize("case", PATHS)
def test_gravity_path_matches_jax_jnp_path(case, monkeypatch):
    """The same chain against the JAX jnp path, 3 steps at 8×8×16."""
    assert_states_close(*run_both((8, 8, 16), case, False, 12,
                                  monkeypatch))


@pytest.mark.parametrize("case", ("ent", "periodic_hydro"))
def test_hydrostatic_start_holds(case):
    """Started at rest in its hydrostatic state, each path stays near it:
    after 3 unforced steps u is below 2 % of the u_z that the same start
    reaches without gravity (about 0.4; the z walls' 'a2' ghosts leave a
    residual of 4e-3 beside them), and in the periodic box, which has no
    wall, below 1e-4 (the stencil's truncation of cos(κz))."""
    kw = dict(PATHS[case][0], forcing=0.0)
    cfg = strat_box((8, 8, 16), **kw)
    cfg = cfg.replace(modules=tuple(
        pt.Hydro() if m.name == "hydro" else m for m in cfg.modules
        if m.name != "magnetic"))
    cfg = cfg.replace(bcz=tuple(bc for bc in cfg.bcz if bc.comp[0] != "a"))
    pm = pt.Model(cfg, device="cpu")
    without = pt.Model(cfg.replace(modules=tuple(
        pt.Gravity(gravz_profile="zero") if m.name == "gravity" else m
        for m in cfg.modules)), device="cpu")
    start = pm.init_state(0)["fields"]
    out = [m.make_multi_step(3)(m.init_state(0, overrides=start))
           for m in (pm, without)]
    held = float(out[0]["fields"]["uu"].abs().max())
    pushed = float(out[1]["fields"]["uu"][2].abs().max())
    assert held < 2e-2 * pushed and pushed > 0.1
    if "periodic" in case:
        assert held < 1e-4
