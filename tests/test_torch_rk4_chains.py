"""One step of the conv-slab and shear-box chains of pencil_tpu_torch at
the 2N-RK order 4 against the JAX fused steps: the zghost chain runs K6
and K7 four times, the zroll chain five shock pre-passes and fills, K4 and
K5 four times.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode.  Bounds are those of tests/test_fused.py: each
field within 2e-5 × its max, dt within 1e-6 relative.
"""
import dataclasses

import jax
import numpy as np
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import conv_slab, shear_box
from test_torch_model import assert_states_close

torch.set_num_threads(1)


def with_order(cfg, itorder, **time):
    return dataclasses.replace(cfg, time=dataclasses.replace(
        cfg.time, itorder=itorder, **time))


def test_conv_slab_rk4_step_matches_jax_fused(monkeypatch):
    """One zghost step at order 4 (K6, K7 four times) against the JAX
    fused step, with one JAX tile over the domain (the Gravity tile fault,
    ROADMAP Queue 3) and 1e-2 velocity noise (tests/test_torch_zghost.py,
    UU_AMPL)."""
    shape = (8, 8, 16)
    monkeypatch.setenv("PC_TX", "8")
    monkeypatch.setenv("PC_CX", "8")
    jm = pj.Model(with_order(conv_slab(shape, pkg=pj), 4))
    pm = pt.Model(with_order(conv_slab(shape), 4), device="cpu")
    uu = (1e-2 * np.random.default_rng(11).standard_normal(
        (3,) + shape)).astype(np.float32)
    js = jm.init_state(11, overrides={"uu": uu})
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(11, overrides=overrides_from_numpy(fields, pm.reg))
    js, ps = jm.make_step()(js), pm.make_step()(ps)
    assert_states_close(js, ps)


def test_shear_box_rk4_step_matches_jax_fused():
    """One zroll step at order 4 (five shock pre-passes and fills, K4, K5
    four times) against the JAX fused step, from t = 0.37, where the
    shifted faces are not a whole number of cells."""
    cfg = {pkg: with_order(shear_box(8, pkg=pkg), 4, tstart=0.37)
           for pkg in (pj, pt)}
    jm, pm = pj.Model(cfg[pj]), pt.Model(cfg[pt], device="cpu")
    js = jm.init_state(5)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(5, overrides=overrides_from_numpy(fields, pm.reg))
    js, ps = jax.jit(jm.make_step())(js), pm.make_step()(ps)
    assert_states_close(js, ps)
