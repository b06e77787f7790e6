"""Hydro's ``lremove_mean_momenta`` in pencil_tpu_torch against
pencil_tpu: u −= ⟨ρu⟩/⟨ρ⟩ after each step, after the boundary-plane
writeback and before the forcing kick (JAX's after-step hooks in module
order, Hydro before Forcing).  On the flagship chain the last kernel then
launches without its kick and the kick follows the removal (JAX's
``kick_ok``); the shear box's chain kicks after the step anyway.  Here:
the removal against JAX's hook, the forced flagship at orders 3 and 1
and the sheared box with SAFI and the mesh flavour (the configuration of
shearing-box MRI runs) against the JAX fused step, the launches, and the
gate.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode, JAX's forcing draws injected through
``Model.forcing_draws``.  The kick has zero mean in u but not in ρu, so
the two orders of removal and kick differ by more than the bound.
Bounds, those of tests/test_fused.py: each field within 2e-5 × its max,
dt within 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch import configs
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.model import fused_gate, fused_mode
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_model import jax_forcing_draws

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
NSTEPS = 2
SHAPE = (8, 8, 16)


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def flagship(pkg, itorder=3, fused=True):
    cfg = configs.flagship(SHAPE, fused=fused, pkg=pkg,
                           remove_mean_momenta=True)
    return dataclasses.replace(cfg, time=dataclasses.replace(
        cfg.time, itorder=itorder))


def fields(shape, seed):
    """u and A noise of 1e-2, lnρ of 0.3 about 0 (a density that varies by
    a third, so ⟨ρ δu⟩ of the kick is far from 0)."""
    rng = np.random.default_rng(seed)
    return {"uu": (1e-2 * rng.standard_normal((3,) + shape)).astype(
                np.float32),
            "lnrho": (0.3 * rng.standard_normal(shape)).astype(np.float32),
            "aa": (1e-2 * rng.standard_normal((3,) + shape)).astype(
                np.float32)}


def test_removal_matches_jax_hook():
    """Hydro.remove_mean_momenta against the JAX Hydro's after-step hook,
    and the result carries no mean momentum."""
    f = fields(SHAPE, 3)
    jh = pj.Hydro(lremove_mean_momenta=True)
    want = jh.after_timestep({"uu": jnp.asarray(f["uu"]),
                              "lnrho": jnp.asarray(f["lnrho"])},
                             None, None, None, None, 0.1, 0.0, None)["uu"]
    got = pt.Hydro(lremove_mean_momenta=True).remove_mean_momenta(
        torch.tensor(f["uu"]), torch.tensor(f["lnrho"]))
    assert_field_close(got, want, "uu")
    rho = torch.exp(torch.tensor(f["lnrho"]))
    mom = (rho[None] * got).mean(dim=(1, 2, 3))
    assert float(mom.abs().max()) < 1e-6 * float(got.abs().max())


@pytest.mark.parametrize("itorder", (3, 1), ids=("rk3", "rk1"))
def test_flagship_matches_jax_fused(itorder, monkeypatch):
    """The forced flagship with the mean removal against the JAX fused
    step (which then kicks after the step, out of its kernel), 2 steps:
    the removal comes before the kick.  K3 launches with no kick vector."""
    jm = pj.Model(flagship(pj, itorder))
    pm = pt.Model(flagship(pt, itorder), device="cpu")
    init = fields(SHAPE, 11)
    js = jm.init_state(11, overrides=init)
    ps = pm.init_state(11, overrides=init)
    pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"],
                                              NSTEPS)).__next__
    kicks = []
    last = fr.rhs_tail_last

    def spy(model, fa, df2, coef, kick=None, fake=False):
        kicks.append(kick)
        return last(model, fa, df2, coef, kick, fake)

    monkeypatch.setattr("pencil_tpu_torch.model.rhs_tail_last", spy)
    jstep = jax.jit(jm.make_step())
    for _ in range(NSTEPS):
        js, ps = jstep(js), pm.make_step()(ps)
    assert kicks == ([None] * NSTEPS if itorder == 3 else [])
    np.testing.assert_allclose(float(ps["dt"]), float(js["dt"]),
                               rtol=RTOL_DT)
    for k, v in js["fields"].items():
        assert_field_close(ps["fields"][k], v, k)


def shear_cfg(pkg, fused=True):
    cfg = configs.shear_box((8, 16, 8), fused=fused, pkg=pkg, safi=True,
                            hyper3="mesh", remove_mean_momenta=True)
    return dataclasses.replace(cfg, time=pkg.TimeSpec(itorder=3,
                                                      tstart=0.37))


def test_sheared_mri_box_matches_jax_fused():
    """The sheared, rotating MHD box with SAFI, the mesh flavour of del6
    (η₃ on A), the shock viscosity and the mean removal against the JAX
    fused step, 2 steps from a state with a mean wind (u_y of 0.05 and a
    density that varies by a third); the mean momentum is then 0."""
    jm = pj.Model(shear_cfg(pj))
    pm = pt.Model(shear_cfg(pt), device="cpu")
    assert pm.mode == "zroll" and pm.safi
    init = fields((8, 16, 8), 7)
    init["uu"][1] += 0.05
    js = jm.init_state(7, overrides=init)
    fa = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(7, overrides=overrides_from_numpy(fa, pm.reg))
    jstep = jax.jit(jm.make_step())
    for _ in range(NSTEPS):
        js, ps = jstep(js), pm.make_step()(ps)
    np.testing.assert_allclose(float(ps["dt"]), float(js["dt"]),
                               rtol=RTOL_DT)
    for k in ("uu", "lnrho", "aa"):
        assert_field_close(ps["fields"][k], js["fields"][k], k)
    rho = torch.exp(ps["fields"]["lnrho"])
    mom = (rho[None] * ps["fields"]["uu"]).mean(dim=(1, 2, 3))
    assert float(mom.abs().max()) < 1e-6


def test_packed_step_bit_identical_to_dict_step():
    """With the removal, the packed multi-step is the dict step bit for
    bit on the flagship chain."""
    pm = pt.Model(flagship(pt), device="cpu")
    a = pm.init_state(3)
    for _ in range(2):
        a = pm.make_step()(a)
    b = pm.make_multi_step(2)(pm.init_state(3))
    for k in a["fields"]:
        assert torch.equal(a["fields"][k], b["fields"][k]), k


@pytest.mark.parametrize("make", ("flagship", "shear_box", "conv_slab",
                                  "eager"))
def test_removal_runs_on_every_chain(make):
    """Each chain (wrap, zroll, zghost, and the eager path) takes the
    option, on the card and on the CPU; unforced, the step leaves no mean
    momentum."""
    cfg = {"flagship": lambda: flagship(pt),
           "shear_box": lambda: configs.shear_box(
               8, remove_mean_momenta=True),
           "conv_slab": lambda: _with_removal(configs.conv_slab((8, 8, 16))),
           "eager": lambda: flagship(pt, fused=False)}[make]()
    mode, why = fused_mode(cfg)
    assert why == (None if make != "eager" else "fused=False")
    if make != "eager":
        for dev in ("cpu", "cuda"):
            assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    s = pm.make_step()(pm.init_state(2))
    assert all(bool(torch.isfinite(v).all()) for v in s["fields"].values())
    if pm.forcing is None:
        # unforced, nothing follows the removal
        rho = torch.exp(s["fields"]["lnrho"])
        mom = (rho[None] * s["fields"]["uu"]).mean(dim=(1, 2, 3))
        assert float(mom.abs().max()) < 1e-7


def _with_removal(cfg):
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, lremove_mean_momenta=True)
        if m.name == "hydro" else m for m in cfg.modules))
