"""The z-walled sets without Gravity in pencil_tpu_torch against
pencil_tpu: unstratified boxes between z walls run the zghost chain on the
builds of the sets with gravity, whose g_z vector is then null (an add of
-0).  3 steps of the isothermal layer's four sets with Gravity taken out
(``strat_box(n)``, hydro and MHD, with and without Shear: K6i/K7i,
K6mi/K7mi, K6si/K7si, K6msi/K7msi) and of stratified convection's set
with ss (K6/K7), through the port's chain on the plain versions of its
kernels against the JAX fused step (Pallas in interpret mode) and the JAX
jnp path; the gate and the build each takes; and a z-walled set without
gravity that stays refused.

Every field starts as numpy noise with a seed (u and A 1e-2, lnρ 5e-2, s
1e-2); the sheared sets start at t = 0.37.  The JAX fused side runs one
tile over the whole domain (PC_TX = PC_CX = nx), as the other z-ghosted
tests do.  Bounds, those of tests/test_fused.py: each field within 2e-5 ×
its max, dt within 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import conv_slab, strat_box
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_zghost_mhd import assert_states_close

torch.set_num_threads(1)

NSTEPS = 3
SHAPE = (8, 8, 16)
TSTART = 0.37
AMPL = {"uu": 1e-2, "lnrho": 5e-2, "ss": 1e-2, "aa": 1e-2}


def without_gravity(cfg):
    cfg = cfg.replace(modules=tuple(m for m in cfg.modules
                                    if m.name != "gravity"))
    if cfg.module("shear") is not None:
        cfg = cfg.replace(time=type(cfg.time)(itorder=3, tstart=TSTART))
    return cfg


# each set: (make(pkg, fused), the build it runs on)
SETS = {
    "hydro": (lambda pkg, fused: strat_box(
        SHAPE, pkg=pkg, fused=fused, magnetic=False, shear=False),
        "fused_rhs_zg_iso"),
    "mhd": (lambda pkg, fused: strat_box(
        SHAPE, pkg=pkg, fused=fused, shear=False), "fused_rhs_zg_iso_mag"),
    "shear_hydro": (lambda pkg, fused: strat_box(
        SHAPE, pkg=pkg, fused=fused, magnetic=False),
        "fused_rhs_zg_iso_shear"),
    "shear_mhd": (lambda pkg, fused: strat_box(
        SHAPE, pkg=pkg, fused=fused), "fused_rhs_zg_iso_mag_shear"),
    "convection": (lambda pkg, fused: conv_slab(
        SHAPE, pkg=pkg, fused=fused), "fused_rhs_zg"),
}


def cfg_of(case, pkg, fused=True):
    return without_gravity(SETS[case][0](pkg, fused))


@pytest.fixture(scope="module", params=sorted(SETS))
def runs(request):
    """One set without gravity: the states after NSTEPS steps of the JAX
    fused and jnp paths and of the port's chain, from the same noise."""
    case = request.param
    rng = np.random.default_rng(4)
    pm = pt.Model(cfg_of(case, pt), device="cpu")
    fields = {}
    for name, slot in pm.reg.slots.items():
        shape = ((slot.ncomp,) if slot.ncomp > 1 else ()) + SHAPE
        fields[name] = (AMPL[name] * rng.standard_normal(shape)).astype(
            np.float32)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(SHAPE[0]))
        mp.setenv("PC_CX", str(SHAPE[0]))
        for fused in (True, False):
            jm = pj.Model(cfg_of(case, pj, fused))
            js = jm.init_state(4, overrides=fields)
            step = jm.make_step()
            for _ in range(NSTEPS):
                js = step(js)
            out["jax_fused" if fused else "jax_jnp"] = js
    ps = pm.init_state(4, overrides=overrides_from_numpy(fields, pm.reg))
    out["chain"] = pm.make_multi_step(NSTEPS)(ps)
    out["pm"] = pm
    return out


def test_chain_without_gravity_matches_jax_fused(runs):
    assert_states_close(runs["jax_fused"], runs["chain"])


def test_chain_without_gravity_matches_jax_jnp_path(runs):
    assert_states_close(runs["jax_jnp"], runs["chain"])


@pytest.mark.parametrize("case", sorted(SETS))
def test_gate_takes_the_set_without_gravity(case):
    """The set without Gravity runs the zghost chain on the card and the
    CPU, on the build of its set with gravity, whose g_z is null."""
    cfg = cfg_of(case, pt)
    assert cfg.module("gravity") is None
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode == "zghost"
    assert fr.zg_library(pm) == SETS[case][1]
    assert fr.gravity_vector(pm) is None
    assert fr.zg_profiles(pm)[2] is None


def test_z_walled_shock_set_without_gravity_stays_refused():
    """A z-walled set without gravity that no chain takes: the isothermal
    layer with Shock (the shock slot on a z-walled grid, ROADMAP Queue 2
    item 5) is refused on every device."""
    cfg = cfg_of("hydro", pt)
    cfg = cfg.replace(modules=cfg.modules + (pt.Shock(),))
    assert gate_reason(cfg) is not None and "shock" in gate_reason(cfg)
    for dev in ("cpu", "cuda"):
        with pytest.raises(NotImplementedError, match="Shock"):
            pt.Model(cfg, device=dev)
