"""K8, the memory floor of the flagship chain, in pencil_tpu_torch against
pencil_tpu's ``PC_FAKE_RHS`` branch: each of its three variants (K1, K2
and K3's loads and stores with RHS(f) = f·1.0000001) against the JAX
kernel, and the chain (``Model(fake_rhs=True)``) against the JAX step.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode.  Bounds are those of tests/test_fused.py: each
field within 2e-5 × its max, dt within 1e-6 relative.
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
from test_torch_model import (assert_states_close, initial_fields,
                              jax_forcing_draws)
from test_torch_rk_orders import SHAPE, assert_field_close, noisy_fa, shaped

torch.set_num_threads(1)

NSTEPS = 3


# ---- K8, the memory floor --------------------------------------------------
def test_fake_rhs_chain_matches_jax(monkeypatch):
    """K8's plain versions through the chain (Model(fake_rhs=True))
    against the JAX fused step with PC_FAKE_RHS, 3 forced steps at a fixed
    dt (the fake K1 reports no CFL rate, so an adaptive dt would be
    dtmax)."""
    monkeypatch.setenv("PC_FAKE_RHS", "1")
    jm = pj.Model(shaped(pj, dt=1e-2))
    pm = pt.Model(shaped(pt, dt=1e-2), fake_rhs=True, device="cpu")
    fields = initial_fields(SHAPE, 11, pm.grid.z.numpy())
    js = jm.init_state(11, overrides=fields)
    ps = pm.init_state(11, overrides=fields)
    pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"],
                                              NSTEPS)).__next__
    step = jax.jit(jm.make_step())
    for _ in range(NSTEPS):
        js, ps = step(js), pm.make_step()(ps)
    assert_states_close(js, ps)


@pytest.mark.parametrize("kernel", ("first", "tail_defer", "tail_last"))
def test_fake_kernels_match_jax(monkeypatch, kernel):
    """Each of K8's three variants against the JAX kernel with
    PC_FAKE_RHS, on a fresh JAX Model (its kernels are cached per
    model)."""
    monkeypatch.setenv("PC_FAKE_RHS", "1")
    jm, pm = pj.Model(shaped(pj)), pt.Model(shaped(pt), device="cpu")
    fa, df1 = noisy_fa(SHAPE, 3), noisy_fa(SHAPE, 4)
    z = jm.grid.z
    a, bdt, cprev = -5.0 / 9.0, 0.05, 0.02
    coef = torch.tensor([a, bdt, cprev], dtype=torch.float32)
    if kernel == "first":
        want, dt1 = jm._fused_rhs(SHAPE, False, True, False)(
            jnp.asarray(fa), z)
        got, dt1p = fr.rhs_first(pm, torch.tensor(fa), fake=True)
        assert float(jnp.max(dt1)) == float(dt1p) == 0.0
        want, got = [want], [got]
    elif kernel == "tail_defer":
        want = jm._fused_rhs(SHAPE, True, True, False, True, False, False)(
            jnp.asarray(fa), z, jnp.asarray(df1), a, bdt, cprev=cprev)
        got = fr.rhs_tail_defer(pm, torch.tensor(fa), torch.tensor(df1),
                                coef, fake=True)
    else:
        want = [jm._fused_rhs(SHAPE, True, True, False, False, True, False)(
            jnp.asarray(fa), z, jnp.asarray(df1), a, bdt)]
        got = [fr.rhs_tail_last(pm, torch.tensor(fa), torch.tensor(df1),
                                coef, fake=True)]
    for g, w in zip(got, want):
        for c in range(7):
            assert_field_close(g[c], np.asarray(w)[c], f"{kernel}[{c}]")


def test_fake_rhs_without_a_fixed_dt_raises():
    """K8's K1 reports no CFL rate: with an adaptive dt the step would take
    dt = dtmax and overflow, so the model refuses it."""
    with pytest.raises(NotImplementedError, match="fixed"):
        pt.Model(shaped(pt), fake_rhs=True, device="cpu")
    assert pt.Model(shaped(pt, dt=1e-2), fake_rhs=True,
                    device="cpu").fake_rhs


def test_fake_rhs_outside_its_chain_raises():
    """K8 runs on the flagship's order-3 chain only."""
    with pytest.raises(NotImplementedError):
        pt.Model(shaped(pt, itorder=4, dt=1e-2), fake_rhs=True, device="cpu")
    with pytest.raises(NotImplementedError):
        pt.Model(dataclasses.replace(shaped(pt, dt=1e-2), fused=False),
                 fake_rhs=True, device="cpu")
