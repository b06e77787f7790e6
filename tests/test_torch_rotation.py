"""Rotation on the flagship template, and the forced shear box, in
pencil_tpu_torch against pencil_tpu: the Coriolis force −2Ω×u in K1 and
K1h (plain versions) against the Pallas kernel, the fused chain of forced
hydro with Ω and of the flagship with Ω against the JAX fused step, and
the zroll chain with the forcing kick after the step against the JAX
fused zroll step.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode, with JAX's forcing draws injected through
``Model.forcing_draws``.  The shear box starts at t = 0.37, where deltay =
0.555·Ly is not a whole number of cells.  Bounds are those of
tests/test_fused.py: each field within 2e-5 × its max, dt within 1e-6
relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import forced_hydro, shear_box
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_forced_hydro import hydro_fields
from test_torch_model import (assert_states_close, flagship, initial_fields,
                              jax_forcing_draws)
from test_torch_rk_orders import assert_field_close

torch.set_num_threads(1)

N = 16
NSTEPS = 3
OMEGA = 1.0
RTOL_DT = 1e-6


def with_hydro(cfg, pkg, **kw):
    """cfg with its Hydro module rebuilt with ``kw`` added."""
    def hydro(m):
        fields = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}
        return pkg.Hydro(**{**fields, **kw})
    return dataclasses.replace(cfg, modules=tuple(
        hydro(m) if m.name == "hydro" else m for m in cfg.modules))


def rotating_flagship(pkg, n=N):
    return with_hydro(flagship(pkg, n=n), pkg, Omega=OMEGA)


def run_both(cfg_fn, make_fields, seed=11, nsteps=NSTEPS):
    """The JAX fused step and the port's fused chain from the same fields,
    with the same forcing draws."""
    jm, pm = pj.Model(cfg_fn(pj)), pt.Model(cfg_fn(pt), device="cpu")
    assert pm.mode == "wrap"
    fields = make_fields(jm.cfg.grid.shape, seed, pm.grid.z.numpy())
    js = jm.init_state(seed, overrides=fields)
    ps = pm.init_state(seed, overrides=fields)
    pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"],
                                              nsteps)).__next__
    jstep = jax.jit(jm.make_step())
    for _ in range(nsteps):
        js, ps = jstep(js), pm.make_step()(ps)
    return js, ps


def test_rotating_forced_hydro_matches_jax_fused():
    """Forced hydro with Ω = 1 (K1h, K2h, K3h with −2Ω×u), 3 steps."""
    js, ps = run_both(lambda pkg: forced_hydro(N, pkg=pkg, Omega=OMEGA),
                      hydro_fields)
    assert_states_close(js, ps)


def test_rotating_flagship_matches_jax_fused():
    """The MHD flagship with Ω = 1 (K1, K2, K3 with −2Ω×u), 3 steps."""
    js, ps = run_both(rotating_flagship, initial_fields)
    assert_states_close(js, ps)


# ---- −2Ω×u in K1 and K1h against the Pallas kernel --------------------------
SHAPE = (8, 8, 16)


@pytest.mark.parametrize("which", ("flagship", "hydro"))
def test_rhs_first_with_coriolis_matches_pallas(which):
    """K1 (7 fields) and K1h (4 fields) with Ω at 30° from z, so that two
    components of Ω act, against the JAX kernel; the term is a visible
    part of du/dt."""
    if which == "flagship":
        def cfg(pkg):
            return with_hydro(flagship(pkg), pkg, Omega=OMEGA, theta=30.0)
    else:
        def cfg(pkg):
            return with_hydro(forced_hydro(SHAPE, pkg=pkg), pkg,
                              Omega=OMEGA, theta=30.0)
    jcfg, pcfg = cfg(pj), cfg(pt)
    jcfg = jcfg.replace(grid=dataclasses.replace(jcfg.grid, nx=8, ny=8,
                                                 nz=16))
    pcfg = pcfg.replace(grid=dataclasses.replace(pcfg.grid, nx=8, ny=8,
                                                 nz=16))
    jm, pm = pj.Model(jcfg), pt.Model(pcfg, device="cpu")
    nc = pm.reg.nvar
    rng = np.random.default_rng(3)
    amp = np.array([1e-2] * 3 + [5e-2] + [1e-2] * (nc - 4))
    fa = (amp[:, None, None, None]
          * rng.standard_normal((nc,) + SHAPE)).astype(np.float32)
    want, dt1 = jm._fused_rhs(SHAPE, False, True, False)(jnp.asarray(fa),
                                                          jm.grid.z)
    got, dt1m = fr.rhs_first(pm, torch.tensor(fa))
    np.testing.assert_allclose(float(dt1m), float(jnp.max(dt1)),
                               rtol=RTOL_DT)
    for c in range(nc):
        assert_field_close(got[c], np.asarray(want)[c], f"df[{c}]")
    still = pt.Model(with_hydro(pcfg, pt, Omega=0.0), device="cpu")
    du = got[:3] - fr.rhs_first(still, torch.tensor(fa))[0][:3]
    assert float(du.abs().max()) > 1e-2 * float(got[:3].abs().max())


# ---- the forced shear box ------------------------------------------------------
TSTART = 0.37


def forced_shear_box(pkg):
    cfg = shear_box(N, pkg=pkg)
    return dataclasses.replace(
        cfg, time=pkg.TimeSpec(itorder=3, tstart=TSTART),
        modules=cfg.modules + (pkg.Forcing(force=0.07, kf=3.0),))


def test_forced_shear_box_matches_jax_fused():
    """The zroll chain (plain K4/K5) with the forcing kick after the step
    against the JAX fused zroll step, which kicks in after_timestep; 3
    steps from t = 0.37 with JAX's draws."""
    jm = pj.Model(forced_shear_box(pj))
    pm = pt.Model(forced_shear_box(pt), device="cpu")
    assert pm.mode == "zroll" and pm.forcing is not None
    js = jm.init_state(5)
    init = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(5, overrides=overrides_from_numpy(init, pm.reg))
    pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"],
                                              NSTEPS)).__next__
    jstep = jax.jit(jm.make_step())
    for _ in range(NSTEPS):
        js, ps = jstep(js), pm.make_step()(ps)
    np.testing.assert_allclose(float(ps["dt"]), float(js["dt"]), rtol=RTOL_DT)
    np.testing.assert_allclose(float(ps["t"]), float(js["t"]), rtol=RTOL_DT)
    for k in ("uu", "lnrho", "aa", "shock"):
        assert_field_close(ps["fields"][k], js["fields"][k], k)
