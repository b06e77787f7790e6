"""Continuous forcing on the aux and z-ghosted chains of pencil_tpu_torch
against pencil_tpu on the CPU: 3 steps of the sheared box (zroll, from t
= 0.37), the hydro shocked box (wrap_aux, its kicks kept), forced
isothermal stratified MHD (``strat_box(n, shear=False, forcing=0.05)``,
zghost K6mi/K7mi) and stratified convection (zghost K6/K7), each driven
by two of the four ported profiles in turn, through the port's fused
chain on the plain versions of its kernels against the JAX fused step
(Pallas in interpret mode) and the JAX jnp path, and through the eager
path against the jnp path.  The wrap chain is in tests/test_torch_fcont.py.

The JAX fused side runs one tile over the whole domain (PC_TX = PC_CX =
nx): the sets under gravity need it (ROADMAP Queue 3), the others take it
as well.  Each profile's amplitude puts the forcing's maximum at 0.1 (the
'xz' envelope scaled by its box).  Velocity and vector-potential noise of
1e-2 from numpy with a seed, the kicked sets kicked with the JAX step's
own draws.  The JAX jnp path keeps the shock slot at its initial zeros, as
the port's eager path does; the fused chains hold their last pre-pass: the
jnp comparisons leave the slot out.  Bounds, those of tests/test_fused.py:
each field within 2e-5 × its max, dt within 1e-6 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import conv_slab, shear_box, shock_box, strat_box
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_bext import evolved
from test_torch_model import jax_forcing_draws
from test_torch_zghost_mhd import AA_AMPL, UU_AMPL, assert_states_close

torch.set_num_threads(1)

NSTEPS = 3
SHAPE = (8, 8, 16)
TSTART = 0.37


def with_fcont(pkg, cfg, profile):
    """``cfg`` driven by the continuous forcing ``profile`` at k1_ff = 1
    with its maximum at 0.1, on its Forcing module (whose kicks stay) or
    on a new one without kicks (force = 0)."""
    gs = cfg.grid
    ampl = 0.1 / ((gs.Lx / 2) ** 2 * (gs.Lz / 2) ** 2) if profile == "xz" \
        else 0.1
    kw = dict(lforcing_cont=True, iforcing_cont=profile, ampl_ff=ampl,
              k1_ff=1.0, fcont_box=(gs.x0, gs.x0 + gs.Lx, gs.z0,
                                    gs.z0 + gs.Lz))
    forcing = cfg.module("forcing")
    if forcing is None:
        return cfg.replace(modules=cfg.modules + (pkg.Forcing(force=0.0,
                                                              **kw),))
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, **kw) if m.name == "forcing" else m
        for m in cfg.modules))


# each set: (make(pkg, fused), the port's mode, its two profiles)
SETS = {
    "shear_box": (lambda pkg, fused: shear_box(SHAPE, pkg=pkg, fused=fused)
                  .replace(time=pkg.TimeSpec(itorder=3, tstart=TSTART)),
                  "zroll", ("ABC", "xz")),
    "hydro_shock_box": (lambda pkg, fused: shock_box(
        SHAPE, pkg=pkg, fused=fused, magnetic=False), "wrap_aux",
        ("RobertsFlow", "cosx*cosy*cosz")),
    "forced_strat_mhd": (lambda pkg, fused: strat_box(
        SHAPE, pkg=pkg, fused=fused, shear=False, forcing=0.05), "zghost",
        ("ABC", "RobertsFlow")),
    "conv_slab": (lambda pkg, fused: conv_slab(SHAPE, pkg=pkg, fused=fused),
                  "zghost", ("cosx*cosy*cosz", "xz")),
}
CASES = [(s, p) for s, (_, _, profs) in SETS.items() for p in profs]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{s}-{p}" for s, p in CASES])
def runs(request):
    """One set with one profile: the states after NSTEPS steps of the JAX
    fused and jnp paths, and of the port's fused chain and eager path,
    all from the JAX init with u (and A) replaced by numpy noise."""
    case, profile = request.param
    make, mode, _ = SETS[case]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(SHAPE[0]))
        mp.setenv("PC_CX", str(SHAPE[0]))
        jms = {fused: pj.Model(with_fcont(pj, make(pj, fused), profile))
               for fused in (True, False)}
        pms = {fused: pt.Model(with_fcont(pt, make(pt, fused), profile),
                               device="cpu") for fused in (True, False)}
        assert pms[True].mode == mode and pms[False].mode is None
        assert fr.fcont_tensor(pms[True]) is not None
        rng = np.random.default_rng(5)
        over = {"uu": (UU_AMPL * rng.standard_normal((3,) + SHAPE))
                .astype(np.float32)}
        if "aa" in pms[True].reg.slots:
            over["aa"] = (AA_AMPL * rng.standard_normal((3,) + SHAPE)) \
                .astype(np.float32)
        out = {}
        for fused, jm in jms.items():
            js = jm.init_state(5, overrides=over)
            fields = {k: np.asarray(v) for k, v in js["fields"].items()}
            draws = (jax_forcing_draws(jm, js["key"], NSTEPS)
                     if pms[fused].forcing is not None else None)
            step = jm.make_step()
            for _ in range(NSTEPS):
                js = step(js)
            out["jax_fused" if fused else "jax_jnp"] = js
        for fused, pm in pms.items():
            ps = pm.init_state(5, overrides=overrides_from_numpy(fields,
                                                                 pm.reg))
            if pm.forcing is not None:
                pm.forcing_draws = iter(draws).__next__
            step = pm.make_step()
            for _ in range(NSTEPS):
                ps = step(ps)
            out["chain" if fused else "eager"] = ps
    return out


def test_chain_with_fcont_matches_jax_fused(runs):
    """The port's chain against the JAX fused step, the shock slot too."""
    assert_states_close(runs["jax_fused"], runs["chain"])


def test_chain_with_fcont_matches_jax_jnp_path(runs):
    assert_states_close(evolved(runs["jax_jnp"]), evolved(runs["chain"]))


def test_eager_step_with_fcont_matches_jax_jnp_path(runs):
    assert_states_close(evolved(runs["jax_jnp"]), evolved(runs["eager"]))
