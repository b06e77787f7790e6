"""Three steps of non-isothermal forced turbulence
(``configs.forced_entropy``, with and without Magnetic) in pencil_tpu_torch
against pencil_tpu, at the 2N-RK orders 1-4: the port's fused chain (plain
kernel versions on the CPU) against the JAX fused step (Pallas in
interpret mode) at orders 1-3, and against the JAX jnp path at order 4,
where the JAX fused step fails (a fault of the reference, ROADMAP Queue
3).  Both start from the same numpy fields and see the same forcing draws
(``Model.forcing_draws``).  One case adds K-const conduction, one Ω = 1.
Each field within 2e-5 × its max, dt within 1e-6 relative.
"""
import jax
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from test_torch_entropy_box import K_AND_CHI, config, ent_fields
from test_torch_model import assert_states_close, jax_forcing_draws

torch.set_num_threads(1)

NSTEPS = 3


def run_both(jcfg, pcfg, seed=11, nsteps=NSTEPS):
    jm, pm = pj.Model(jcfg), pt.Model(pcfg, device="cpu")
    assert pm.mode == "wrap"
    magnetic = "aa" in pm.reg.slots
    fields = ent_fields(jm.cfg.grid.shape, seed, pm.grid.z.numpy(), magnetic)
    js = jm.init_state(seed, overrides=fields)
    ps = pm.init_state(seed, overrides=fields)
    pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"],
                                              nsteps)).__next__
    jstep = jax.jit(jm.make_step())
    for _ in range(nsteps):
        js, ps = jstep(js), pm.make_step()(ps)
    return js, ps


@pytest.mark.parametrize("itorder", (1, 2, 3, 4),
                         ids=("rk1", "rk2", "rk3", "rk4"))
@pytest.mark.parametrize("magnetic", (True, False), ids=("mhd", "hydro"))
def test_forced_entropy_matches_jax(magnetic, itorder):
    """K1e (+ axpy and the kick after the step), K1e + K2Le, K1e + K2e +
    K3e against the JAX fused step; K1e, K2e, 2×K3′e, K3e against the JAX
    jnp path."""
    js, ps = run_both(
        config(pj, magnetic=magnetic, itorder=itorder, fused=itorder < 4),
        config(pt, magnetic=magnetic, itorder=itorder))
    assert_states_close(js, ps)


@pytest.mark.parametrize("case", ("mhd-K-const", "hydro-Omega"))
def test_forced_entropy_options_match_jax_fused(case):
    """K-const conduction beside chi-const (a CFL rate per point) on the
    8-field set, and the Coriolis force on the 5-field set, at order 3."""
    kw = dict(magnetic=True, entropy=K_AND_CHI) if case == "mhd-K-const" \
        else dict(magnetic=False, Omega=1.0)
    js, ps = run_both(config(pj, **kw), config(pt, **kw))
    assert_states_close(js, ps)


def test_forced_entropy_heats_and_grows_urms():
    """Production draws: the forcing raises urms, viscous and Ohmic heating
    raise the mean entropy, dt stays CFL-limited."""
    pm = pt.Model(config(pt), device="cpu")
    s = pm.init_state(0)
    u0 = float(s["fields"]["uu"].pow(2).sum(0).mean().sqrt())
    s = pm.make_multi_step(5)(s)
    u1 = float(s["fields"]["uu"].pow(2).sum(0).mean().sqrt())
    assert all(torch.isfinite(v).all() for v in s["fields"].values())
    assert u1 > u0
    assert float(s["fields"]["ss"].mean()) > 0.0
    assert 0.0 < float(s["dt"]) < pm.cfg.time.dtmax
