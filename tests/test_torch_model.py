"""The port's step against the JAX package's, over several steps.

Both packages start from the same numpy fields (``init_state(overrides=)``)
and see the same forcing draws: the test rebuilds the forcing sub-key the
way the JAX step splits it (model.py:681-687, :914-916), reads (idx, phase,
e) from ``jax.random`` and injects them through ``Model.forcing_draws``.
Bounds are those of tests/test_fused.py:75-84: each field within 2e-5 ×
its max, dt within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.physics.forcing import shell_vectors

torch.set_num_threads(1)

NSTEPS = 4


def flagship(pkg, n=16, fused=True):
    return pkg.Config(
        grid=pkg.GridSpec(nx=n, ny=n, nz=n), time=pkg.TimeSpec(itorder=3),
        fused=fused,
        modules=(pkg.EosIdealGas(gamma=1.0, cs0=1.0),
                 pkg.Density(lupw_lnrho=False),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-3),
                 pkg.Viscosity(ivisc=("nu-const",), nu=5e-3),
                 pkg.Magnetic(init="gaussian-noise", ampl=1e-4, eta=5e-3),
                 pkg.Forcing(force=0.07, kf=3.0)))


def sinwave_mhd(pkg):
    """The unforced MHD configuration of test_fused.py:20-29 at 16³."""
    return pkg.Config(
        grid=pkg.GridSpec(nx=16, ny=16, nz=16), time=pkg.TimeSpec(itorder=3),
        fused=True,
        modules=(pkg.EosIdealGas(gamma=1.0001),
                 pkg.Density(init="sinwave-z", ampl=0.05),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-2),
                 pkg.Viscosity(ivisc=("nu-const",), nu=2e-3),
                 pkg.Magnetic(init="gaussian-noise", ampl=1e-3, eta=2e-3)))


def initial_fields(shape, seed, z):
    rng = np.random.default_rng(seed)
    return {
        "uu": (1e-2 * rng.standard_normal((3,) + shape)).astype(np.float32),
        "lnrho": (0.05 * np.sin(z)[None, None, :]
                  + 1e-3 * rng.standard_normal(shape)).astype(np.float32),
        "aa": (1e-3 * rng.standard_normal((3,) + shape)).astype(np.float32),
    }


def jax_forcing_draws(jm, key, nsteps):
    """Each step's (idx, phase, e) as the JAX step draws them, as torch
    tensors, by replaying its split of the state key."""
    forcing = jm.cfg.module("forcing")
    nk = len(shell_vectors(forcing.kf, forcing.dk))
    out = []
    for _ in range(nsteps):
        k = key
        for m in jm.modules:
            k, sub = jax.random.split(k)
            if m.name == "forcing":
                sub_f = sub
        key = k
        k_idx, k_phase, k_e = jax.random.split(sub_f, 3)
        out.append((
            torch.tensor([int(jax.random.randint(k_idx, (), 0, nk))]),
            torch.tensor(np.asarray(jax.random.uniform(
                k_phase, (), minval=-jnp.pi, maxval=jnp.pi))),
            torch.tensor(np.asarray(jax.random.normal(k_e, (3,),
                                                      dtype=jnp.float32)))))
    return out


def run_both(cfg_fn, seed, nsteps=NSTEPS):
    jm = pj.Model(cfg_fn(pj))
    pm = pt.Model(cfg_fn(pt), device="cpu")
    gs = jm.cfg.grid
    fields = initial_fields(gs.shape, seed, pm.grid.z.numpy())
    js = jm.init_state(seed, overrides=fields)
    ps = pm.init_state(seed, overrides=fields)
    if pm.forcing is not None:
        pm.forcing_draws = iter(jax_forcing_draws(
            jm, js["key"], nsteps)).__next__
    jstep, pstep = jm.make_step(), pm.make_step()
    for _ in range(nsteps):
        js, ps = jstep(js), pstep(ps)
    return js, ps


def assert_states_close(js, ps):
    np.testing.assert_allclose(float(ps["dt"]), float(js["dt"]), rtol=1e-6)
    np.testing.assert_allclose(float(ps["t"]), float(js["t"]), rtol=1e-6)
    assert int(ps["it"]) == int(js["it"])
    for k, b in js["fields"].items():
        a = ps["fields"][k].numpy().astype(np.float64)
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape, k
        err = np.abs(a - b).max()
        assert err < 2e-5 * max(np.abs(b).max(), 1e-3), (k, err)


@pytest.mark.parametrize("cfg_fn", (flagship, sinwave_mhd),
                         ids=("flagship", "sinwave_mhd"))
def test_fused_step_matches_jax(cfg_fn):
    """The fused chain (plain versions on the CPU) against the JAX fused
    step (Pallas interpret mode), 4 steps."""
    js, ps = run_both(cfg_fn, seed=11)
    assert_states_close(js, ps)


def test_eager_step_matches_jax_jnp_path():
    """fused=False: the port's eager CPU path, with the kick applied after
    the substeps, against the JAX jnp path."""
    js, ps = run_both(lambda pkg: flagship(pkg, fused=False), seed=12)
    assert_states_close(js, ps)


def test_packed_step_bit_identical_to_dict_step():
    """pack_state carries one stacked tensor; a packed step and a chunked
    multi-step must equal the dict step bit for bit, RNG stream included."""
    pm = pt.Model(flagship(pt), device="cpu")
    runs = []
    for mode in ("dict", "packed", "multi"):
        s = pm.init_state(7)
        if mode == "multi":
            s = pm.make_multi_step(3)(s)
        else:
            if mode == "packed":
                s = pm.pack_state(s)
                assert "_fa" in s
            step = pm.make_step()
            for _ in range(3):
                s = step(s)
            s = pm.unpack_state(s)
        runs.append(s)
    ref = runs[0]
    for s in runs[1:]:
        for key in ("t", "dt", "it"):
            assert torch.equal(s[key], ref[key]), key
        for k in ref["fields"]:
            assert torch.equal(s["fields"][k], ref["fields"][k]), k


def test_forced_flagship_grows_urms():
    """Production draws (torch.Generator): forcing 0.07 against 1e-3 noise
    raises urms, and dt stays positive and CFL-limited."""
    pm = pt.Model(flagship(pt), device="cpu")
    s = pm.init_state(0)
    u0 = float(s["fields"]["uu"].pow(2).sum(0).mean().sqrt())
    s = pm.make_multi_step(5)(s)
    u1 = float(s["fields"]["uu"].pow(2).sum(0).mean().sqrt())
    assert all(torch.isfinite(v).all() for v in s["fields"].values())
    assert u1 > u0
    assert 0.0 < float(s["dt"]) < pm.cfg.time.dtmax
