"""Forced convection and forced magnetoconvection (``conv_slab(n,
forcing=...)``, with and without Shear) in pencil_tpu_torch against
pencil_tpu: 3 steps of the port's zghost chain, the helical forcing kick
after the boundary-plane writeback, against the JAX fused (zghost) step
and the jnp path with the same forcing draws (JAX's, injected through
``Model.forcing_draws``); the kick shown to act; and the gate's refusals:
the sets that stay outside every chain, each refused for its modules.

The JAX side runs as tests/test_torch_zghost_shear.py runs it: the Pallas
kernels in interpret mode with one tile over the whole domain (PC_TX =
PC_CX = nx), velocity and vector-potential noise of 1e-2, the sheared
sets from t = 0.37.  Bounds, those of tests/test_fused.py: each field
within 2e-5 × its max, dt within 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import conv_slab
from pencil_tpu_torch.model import fused_gate, fused_mode, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_model import jax_forcing_draws
from test_torch_zghost_mhd import (AA_AMPL, UU_AMPL, assert_states_close,
                                   noisy_fields)

torch.set_num_threads(1)

FORCE = 0.05
TSTART = 0.37
NSTEPS = 3
# the forced sets: conv_slab keyword arguments
CASES = {"conv": {}, "mag": dict(magnetic=True),
         "shear": dict(Omega=0.5, shear=True),
         "mag_shear": dict(Omega=0.5, shear=True, magnetic=True)}


def forced_cfg(pkg, shape, case, fused=True, force=FORCE):
    cfg = conv_slab(shape, fused=fused, pkg=pkg, forcing=force,
                    **CASES[case])
    if "shear" in case:
        cfg = cfg.replace(time=pkg.TimeSpec(itorder=3, tstart=TSTART))
    return cfg


def initial_overrides(shape, magnetic, seed):
    rng = np.random.default_rng(seed)
    over = {"uu": (UU_AMPL * rng.standard_normal((3,) + shape))
            .astype(np.float32)}
    if magnetic:
        over["aa"] = (AA_AMPL * rng.standard_normal((3,) + shape)).astype(
            np.float32)
    return over


def run_both(shape, case, jax_fused, seed, monkeypatch):
    """The JAX package (fused or jnp path) and the port's zghost chain,
    NSTEPS steps from the JAX init with u (and A) replaced by numpy noise,
    both kicked with the JAX step's forcing draws."""
    if jax_fused:
        monkeypatch.setenv("PC_TX", str(shape[0]))
        monkeypatch.setenv("PC_CX", str(shape[0]))
    jm = pj.Model(forced_cfg(pj, shape, case, fused=jax_fused))
    pm = pt.Model(forced_cfg(pt, shape, case), device="cpu")
    assert pm.mode == "zghost" and pm.forcing is not None
    js = jm.init_state(seed, overrides=initial_overrides(
        shape, "aa" in pm.reg.slots, seed))
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(seed, overrides=overrides_from_numpy(fields, pm.reg))
    pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"], NSTEPS)).__next__
    jstep, pstep = jm.make_step(), pm.make_step()
    for _ in range(NSTEPS):
        js, ps = jstep(js), pstep(ps)
    return js, ps


@pytest.mark.parametrize("case", CASES)
def test_forced_step_matches_jax_fused(case, monkeypatch):
    """The port's forced zghost chain (plain K6/K7, K6m/K7m, K6s/K7s or
    K6ms/K7ms on the CPU, the kick after the writeback) against the JAX
    fused zghost step, 3 steps at 16³."""
    assert_states_close(*run_both((16, 16, 16), case, True, 21,
                                  monkeypatch))


@pytest.mark.parametrize("case", ("conv", "mag_shear"))
def test_forced_step_matches_jax_jnp_path(case, monkeypatch):
    """The same chain against the JAX jnp path, 3 steps at 8×8×16."""
    assert_states_close(*run_both((8, 8, 16), case, False, 22, monkeypatch))


@pytest.mark.parametrize("case", CASES)
def test_kick_acts_after_the_writeback(case):
    """The forced step is the unforced step with the kick added to u after
    the writeback: the same draws' kick of the unforced step's result
    gives it bit for bit, and the kick moves u (it may move the walls' u_z
    off 0, as the JAX step's kick after its writeback does)."""
    shape = (8, 8, 16)
    forced = pt.Model(forced_cfg(pt, shape, case), device="cpu")
    plain = pt.Model(forced_cfg(pt, shape, case, force=0.0), device="cpu")
    assert plain.forcing is None
    g = torch.Generator().manual_seed(3)
    draw = (torch.randint(0, 20, (1,), generator=g),
            torch.rand((), generator=g) * 6.0 - 3.0, torch.randn(3,
                                                                 generator=g))
    forced.forcing_draws = lambda: draw
    fa = torch.tensor(noisy_fields(forced, np.random.default_rng(4)))
    s0 = forced.init_state(0)
    state = {"_fa": fa, "t": s0["t"], "dt": s0["dt"], "it": s0["it"]}
    got = forced.make_step()(state)
    want = plain.make_step()(state)
    assert torch.equal(got["dt"], want["dt"])
    kicked = forced._kick_after(want["_fa"], want["dt"])
    assert torch.equal(got["_fa"], kicked)
    du = float((got["_fa"][:3] - want["_fa"][:3]).abs().max())
    assert du > 1e-3 * float(want["_fa"][:3].abs().max())


@pytest.mark.parametrize("case", CASES)
def test_gate_admits_the_forced_sets(case):
    """Each forced set runs the zghost chain on the card and on the CPU,
    on the build of its unforced set, under the same launch names."""
    cfg = forced_cfg(pt, 8, case)
    assert fused_mode(cfg) == ("zghost", None)
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    unforced = pt.Model(forced_cfg(pt, 8, case, force=0.0), device="cpu")
    assert fr.zg_library(pm) == fr.zg_library(unforced)
    assert fr.zg_kernels(pm) == fr.zg_kernels(unforced)


def _with_shock(cfg):
    return cfg.replace(modules=cfg.modules + (pt.Shock(),))


def _without(cfg, name):
    return cfg.replace(modules=tuple(m for m in cfg.modules
                                     if m.name != name),
                       bcz=tuple(bc for bc in cfg.bcz
                                 if name != "entropy" or bc.comp != "ss"))


# sets outside every chain and the module the reason must name: the
# conv-slab with Shock, the forced isothermal set under gravity with z
# walls and Shock (with z walls alone it runs since the builds without
# ss, tests/test_torch_zghost_iso.py, and on a fully periodic grid since
# gravity on every chain, tests/test_torch_gravity_chains.py), the sheared
# isothermal set with Shock, and the sheared slab without gravity with
# Shock (without gravity alone it runs since the z-walled sets without
# Gravity, tests/test_torch_bext.py)
REFUSED = {
    "shock": (lambda: conv_slab(8).replace(
        modules=conv_slab(8).modules + (pt.Shock(),)), "shock"),
    "forced_isothermal": (lambda: _with_shock(_without(
        conv_slab(8, forcing=FORCE), "entropy")), "gravity"),
    "sheared_isothermal": (lambda: _with_shock(_without(
        conv_slab(8, Omega=0.5, shear=True), "entropy")), "shear"),
    "sheared_no_gravity": (lambda: _with_shock(_without(
        conv_slab(8, Omega=0.5, shear=True), "gravity")), "shock"),
}


@pytest.mark.parametrize("case", REFUSED)
def test_refusal_names_the_module_set(case):
    """A conv-slab set outside every chain is refused for its modules (the
    reason lists them and the grid's periodicity), not for the layer
    profiles that its Entropy has or lacks: the set is tested first."""
    make, module = REFUSED[case]
    cfg = make()
    reason = gate_reason(cfg)
    assert reason is not None and reason.startswith("modules "), reason
    assert f"'{module}'" in reason.split(" with periodic=")[0], reason
    assert "cool/luminosity" not in reason
    with pytest.raises(NotImplementedError, match="modules "):
        fused_gate(cfg, "cuda")
