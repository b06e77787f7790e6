"""Steps of the isothermal stratified layer (``strat_box``: hydro or MHD,
with or without Shear) in pencil_tpu_torch against pencil_tpu: 3 steps
of the port's zghost chain (the plain K6i/K7i, K6mi/K7mi, K6si/K7si or
K6msi/K7msi on the CPU) against the JAX fused (zghost) step and against
the JAX jnp path, the unsheared sets forced against the JAX fused step
with its own forcing draws (injected through ``Model.forcing_draws``);
gravity and the hydrostatic start shown to act.

The JAX side runs as tests/test_torch_zghost_iso.py runs it: one tile
over the whole domain (PC_TX = PC_CX = nx), velocity and vector-potential
noise of 1e-2 from numpy with a seed (at the configuration's 1e-3 a
velocity beside the O(1) pressure and gravity forces sits near its
float32 floor, tests/test_torch_zghost.py), the sheared sets from t =
0.37.  Bounds, those of tests/test_fused.py: each field within 2e-5 × its
max, dt within 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from test_torch_model import jax_forcing_draws
from test_torch_zghost_iso import CASES, noisy_fields, strat_cfg
from test_torch_zghost_mhd import AA_AMPL, UU_AMPL, assert_states_close

torch.set_num_threads(1)

NSTEPS = 3
FORCE = 0.05


def run_both(shape, case, jax_fused, seed, monkeypatch, force=0.0):
    """The JAX package (fused or jnp path) and the port's zghost chain,
    NSTEPS steps from the JAX init (the isothermal lnρ) with u (and A)
    replaced by numpy noise; forced ones kicked with the JAX step's
    draws."""
    if jax_fused:
        monkeypatch.setenv("PC_TX", str(shape[0]))
        monkeypatch.setenv("PC_CX", str(shape[0]))
    kw = dict(forcing=force) if force else {}
    jm = pj.Model(strat_cfg(pj, shape, case, fused=jax_fused, **kw))
    pm = pt.Model(strat_cfg(pt, shape, case, **kw), device="cpu")
    assert pm.mode == "zghost"
    if jax_fused:
        shear = jm.cfg.module("shear")
        sdy = None if shear is None else shear.deltay(
            jm.cfg.time.tstart, jm.cfg.grid.Lx, jm.cfg.grid.Ly)
        assert jm._fused_mode(None, sdy, shape[2]) == "zghost"
    rng = np.random.default_rng(seed)
    over = {"uu": (UU_AMPL * rng.standard_normal((3,) + shape))
            .astype(np.float32)}
    if "aa" in pm.reg.slots:
        over["aa"] = (AA_AMPL * rng.standard_normal((3,) + shape)).astype(
            np.float32)
    js = jm.init_state(seed, overrides=over)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(seed, overrides=overrides_from_numpy(fields, pm.reg))
    assert float(ps["t"]) == float(js["t"])
    if force:
        assert pm.forcing is not None
        pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"],
                                                  NSTEPS)).__next__
    jstep, pstep = jm.make_step(), pm.make_step()
    for _ in range(NSTEPS):
        js, ps = jstep(js), pstep(ps)
    return js, ps


# the fused comparisons: the unsheared sets forced
FUSED = {case: FORCE if "shear" not in case else 0.0 for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_iso_step_matches_jax_fused(case, monkeypatch):
    """The port's zghost chain against the JAX fused zghost step, 3 steps
    at 16×16×32 (the unsheared sets forced, with JAX's draws)."""
    assert_states_close(*run_both((16, 16, 32), case, True, 11, monkeypatch,
                                  force=FUSED[case]))


@pytest.mark.parametrize("case", CASES)
def test_iso_step_matches_jax_jnp_path(case, monkeypatch):
    """The same chain, unforced, against the JAX jnp path, 3 steps at
    16³."""
    assert_states_close(*run_both((16, 16, 16), case, False, 12,
                                  monkeypatch))


@pytest.mark.parametrize("case", ("iso_mag", "iso_mag_shear"))
def test_gravity_acts(case):
    """Gravity moves the step: without it the hydrostatic lnρ is pushed
    by the unbalanced pressure, and u_z after 2 steps differs by more than
    its own max."""
    shape = (8, 8, 16)
    pm = pt.Model(strat_cfg(pt, shape, case), device="cpu")
    cfg = pm.cfg
    without = pt.Model(cfg.replace(modules=tuple(
        pt.Gravity(gravz_profile=m.gravz_profile, gravz=0.0)
        if m.name == "gravity" else m for m in cfg.modules)), device="cpu")
    fields = pm.reg.unstack(torch.tensor(
        noisy_fields(pm, np.random.default_rng(3))))
    out = [m.make_multi_step(2)(m.init_state(0, overrides=fields))
           for m in (pm, without)]
    uz = out[0]["fields"]["uu"][2]
    gap = float((uz - out[1]["fields"]["uu"][2]).abs().max())
    assert gap > float(uz.abs().max())
