"""The flagship chain at the 2N-RK orders 1, 2 and 4 in pencil_tpu_torch
against pencil_tpu, and its tail kernels K3′ and K2L (plain versions)
against the Pallas kernels.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode, with JAX's forcing draws injected through
``Model.forcing_draws``.  The JAX fused flagship step fails at order 4
(a fault of the reference, ROADMAP Queue 3: its middle substeps build the
``kernel_upd`` call and pass it keywords it does not take), so the port's
order-4 chain is held to the JAX jnp path.  Bounds are those of
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
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_model import (assert_states_close, flagship, initial_fields,
                              jax_forcing_draws)

torch.set_num_threads(1)

N = 16
NSTEPS = 3


def with_order(cfg, itorder, **time):
    return dataclasses.replace(cfg, time=dataclasses.replace(
        cfg.time, itorder=itorder, **time))


def run_both(itorder, jax_fused, seed=11, nsteps=NSTEPS, **time):
    """The JAX step (fused or jnp path) and the port's fused chain from the
    same fields, with the same forcing draws."""
    jm = pj.Model(with_order(flagship(pj, fused=jax_fused), itorder, **time))
    pm = pt.Model(with_order(flagship(pt), itorder, **time), device="cpu")
    assert pm.mode == "wrap"
    fields = initial_fields(jm.cfg.grid.shape, seed, pm.grid.z.numpy())
    js = jm.init_state(seed, overrides=fields)
    ps = pm.init_state(seed, overrides=fields)
    pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"],
                                              nsteps)).__next__
    jstep = jax.jit(jm.make_step())
    for _ in range(nsteps):
        js, ps = jstep(js), pm.make_step()(ps)
    return js, ps


# ---- the flagship chain at each order ---------------------------------------
@pytest.mark.parametrize("itorder", (1, 2), ids=("rk1", "rk2"))
def test_flagship_matches_jax_fused(itorder):
    """Orders 1 (K1, a torch axpy, the kick after the step) and 2 (K1,
    K2L with the kick) against the JAX fused step, 3 forced steps."""
    js, ps = run_both(itorder, jax_fused=True)
    assert_states_close(js, ps)


def test_flagship_rk4_matches_jax_jnp_path():
    """Order 4 (K1, K2, K3′ twice, K3 with the kick) against the JAX jnp
    path, 3 forced steps."""
    js, ps = run_both(4, jax_fused=False)
    assert_states_close(js, ps)


def test_jax_fused_rk4_reference_fault():
    """The reference fault the order-4 test works around (ROADMAP Queue
    3): the JAX fused flagship step at order 4 raises at its middle
    substeps (pencil_tpu/model.py:690-695)."""
    jm = pj.Model(with_order(flagship(pj), 4))
    with pytest.raises(TypeError, match="cprev"):
        jm.make_step()(jm.init_state(1))


@pytest.mark.parametrize("itorder", (1, 2, 4), ids=("rk1", "rk2", "rk4"))
def test_packed_step_bit_identical_to_dict_step(itorder):
    pm = pt.Model(with_order(flagship(pt, n=8), itorder), device="cpu")
    a = pm.init_state(3)
    for _ in range(2):
        a = pm.make_step()(a)
    b = pm.make_multi_step(2)(pm.init_state(3))
    for key in ("t", "dt", "it"):
        assert torch.equal(a[key], b[key]), key
    for k in a["fields"]:
        assert torch.equal(a["fields"][k], b["fields"][k]), k


# ---- K3′ and K2L against the Pallas kernels --------------------------------
# The JAX step's order-4 middle substeps build ``kernel_upd`` with the wrap
# fetch (pencil_tpu/model.py:690 passes no tail flag to make_fused_rhs) and
# then fail on its keywords, so K3′ is held to that kernel, called as
# make_fused_rhs returns it.
SHAPE = (8, 8, 16)
RTOL_FIELD = 2e-5


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def noisy_fa(shape, seed):
    rng = np.random.default_rng(seed)
    amp = np.array([1e-2] * 3 + [5e-2] + [1e-2] * 3)[:, None, None, None]
    return (amp * rng.standard_normal((7,) + shape)).astype(np.float32)


def shaped(pkg, **time):
    cfg = flagship(pkg)
    nx, ny, nz = SHAPE
    cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, nx=nx, ny=ny, nz=nz))
    return dataclasses.replace(cfg, time=dataclasses.replace(cfg.time,
                                                             **time))


@pytest.fixture(scope="module")
def tails():
    """The order-4 middle-substep kernel and kernel_tail(defer_prev=True,
    last=True) with and without the kick of the JAX package (interpret
    mode) on one input, df1 and dt from the port's plain K1 on another;
    numpy results."""
    jm = pj.Model(shaped(pj, itorder=4))
    pm = pt.Model(shaped(pt, itorder=4), device="cpu")
    fa, fa2 = noisy_fa(SHAPE, 3), noisy_fa(SHAPE, 4)
    df1, dt1m = fr.rhs_first(pm, torch.tensor(fa))
    dt = np.float32(1.0 / float(dt1m))
    alpha, beta, _ = jm.rk
    a, bdt, cprev = alpha[2], beta[2] * dt, beta[1] * dt
    out = dict(pm=pm, fa2=fa2, df1=df1.numpy(),
               coef=np.array([a, bdt, cprev], np.float32))
    z = jm.grid.z
    mid = jm._fused_rhs(SHAPE, True, True, False, False, False, False)
    # the calls donate df_prev (JAX alias {2: 0}): each gets a fresh copy
    df, f, _ = mid(jnp.asarray(fa2), z, jnp.asarray(out["df1"]), a, bdt)
    out["mid"] = (np.asarray(df), np.asarray(f))
    kick = jm.cfg.module("forcing").kick_coeffs(
        jax.random.PRNGKey(8), jnp.float32(dt), jm.cfg, jm.eos, jnp.float32)
    out["kick"] = np.concatenate([np.ravel(np.asarray(k)) for k in kick]
                                 + [np.zeros(1)]).astype(np.float32)
    for k in (None, kick):
        fused = jm._fused_rhs(SHAPE, True, True, False, True, True,
                              k is not None)
        out["defer_last", k is None] = np.asarray(fused(
            jnp.asarray(fa2), z, jnp.asarray(out["df1"]), a, bdt,
            cprev=cprev, kick=k))
    return out


def test_rhs_tail_mid_matches_pallas(tails):
    """K3′'s plain version: df (written over df_prev) and f."""
    coef = torch.tensor(tails["coef"])
    df_prev = torch.tensor(tails["df1"])
    df, f = fr.rhs_tail_mid(tails["pm"], torch.tensor(tails["fa2"]), df_prev,
                            coef)
    assert df is df_prev
    for c in range(7):
        assert_field_close(df[c], tails["mid"][0][c], f"df[{c}]")
        assert_field_close(f[c], tails["mid"][1][c], f"f[{c}]")


@pytest.mark.parametrize("kicked", (False, True), ids=("unforced", "kick"))
def test_rhs_tail_defer_last_matches_pallas(tails, kicked):
    """K2L's plain version: f rebuilt from raw f0 and df1, updated, and
    kicked when a kick vector is given."""
    kick = torch.tensor(tails["kick"]) if kicked else None
    f = fr.rhs_tail_defer_last(tails["pm"], torch.tensor(tails["fa2"]),
                               torch.tensor(tails["df1"]),
                               torch.tensor(tails["coef"]), kick)
    want = tails["defer_last", not kicked]
    for c in range(7):
        assert_field_close(f[c], want[c], f"f[{c}]")
