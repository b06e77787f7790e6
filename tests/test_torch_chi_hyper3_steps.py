"""Two steps of the paths of Entropy's hyper-diffusion and cooling in
pencil_tpu_torch against the JAX package's fused step (Pallas in
interpret mode, one tile over the domain: PC_TX = PC_CX = nx), and each
term shown to act.  The paths: (a) hyper-diffusive non-isothermal forced
MHD turbulence with χ₃ and Newtonian cooling (``forced_entropy(n,
hyper3=True, chi_hyper3=True, tau_cool=...)``, K1e-K3e H3), (b)
hyper-diffusive convection with χ₃ (``conv_slab(n, hyper3=True,
chi_hyper3=True)``, K6/K7 H3), and the MHD shear box with ss, the mesh
flavour χ₃ᵐ and the uniform heating and cooling (K4e/K5e H3), from
t = 0.37 so that the shifted faces are not plain wraps.  The port runs
its chains on its kernels' plain versions, the forced path with JAX's
draws.  At 8×8×16, from the JAX start with u, A and s given numpy noise.
Bounds, those of tests/test_fused.py: each field within 2e-5 × its max,
dt within 1e-6 relative.
"""

import functools
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch import configs
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from test_torch_model import jax_forcing_draws
from test_torch_zghost_mhd import RTOL_FIELD, assert_states_close

torch.set_num_threads(1)

SHAPE = (8, 8, 16)
NSTEPS = 2
TSTART = 0.37


# ``cfg`` (of either package) with Entropy's fields replaced
with_entropy = functools.partial(configs.with_module, name="entropy")


# each path: (its configuration in a package, the port's mode, the
# Entropy fields each of whose terms must show)
PATHS = {
    "a forced entropy": (
        lambda pkg: configs.forced_entropy(SHAPE, pkg=pkg, hyper3=True,
                                           chi_hyper3=True, tau_cool=0.5),
        "wrap", ("chi_hyper3", "tau_cool")),
    "b conv-slab": (
        lambda pkg: configs.conv_slab(SHAPE, pkg=pkg, hyper3=True,
                                      chi_hyper3=True),
        "zghost", ("chi_hyper3",)),
    # χ₃ᵐ at 4× the configurations' value, so that two steps show it
    "shear box mesh": (
        lambda pkg: with_entropy(configs.shear_box(
            SHAPE, pkg=pkg, entropy=True),
            chi_hyper3_mesh=4 * configs.MESH_HYPER3, heat_uniform=0.05,
            cool_uniform=0.05).replace(
            time=pkg.TimeSpec(itorder=3, tstart=TSTART)),
        "zroll", ("chi_hyper3_mesh", "heat_uniform")),
}


def overrides(jm, seed):
    """The JAX start's fields with numpy noise added to u, A (1e-2) and s
    (1e-2: T then varies, so the cooling acts)."""
    rng = np.random.default_rng(seed)
    f = {k: np.asarray(v) for k, v in jm.init_state(seed)["fields"].items()}
    for k, amp in (("uu", 1e-2), ("aa", 1e-2), ("ss", 1e-2)):
        if k in f:
            f[k] = (f[k] + amp * rng.standard_normal(f[k].shape)) \
                .astype(np.float32)
    return f


def port_run(cfg, fields, draws=None):
    """NSTEPS steps of the port's chain (plain kernels) from ``fields``."""
    pm = pt.Model(cfg, device="cpu")
    s = pm.init_state(5, overrides=overrides_from_numpy(fields, pm.reg))
    if pm.forcing is not None:
        pm.forcing_draws = iter(draws).__next__
    step = pm.make_step()
    for _ in range(NSTEPS):
        s = step(s)
    return s


@pytest.fixture(scope="module", params=sorted(PATHS))
def path(request):
    """(label, the start's fields, JAX's draws, the JAX fused step's
    state after NSTEPS)."""
    make = PATHS[request.param][0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(SHAPE[0]))
        mp.setenv("PC_CX", str(SHAPE[0]))
        jm = pj.Model(make(pj))
        fields = overrides(jm, 11)
        js = jm.init_state(5, overrides=fields)
        draws = (jax_forcing_draws(jm, js["key"], NSTEPS)
                 if jm.cfg.module("forcing") is not None else None)
        step = jm.make_step()
        for _ in range(NSTEPS):
            js = step(js)
    return request.param, fields, draws, js


def test_chain_matches_jax_fused(path):
    """The port's chain on the H3 instances' plain versions with s's del6
    (and the cooling terms) against the JAX fused step, the shock slot
    too."""
    label, fields, draws, js = path
    make, mode, _ = PATHS[label]
    cfg = make(pt)
    assert pt.Model(cfg, device="cpu").mode == mode
    assert_states_close(js, port_run(cfg, fields, draws))


def test_each_term_shows(path):
    """With one of the path's terms off (χ₃, χ₃ᵐ, tau_cool, the uniform
    heating and cooling), s ends more than 100× the parity bound away
    from the run with all of them: none can be silently off."""
    label, fields, draws, _ = path
    make, _, terms = PATHS[label]
    cfg = make(pt)
    ref = port_run(cfg, fields, draws)["fields"]["ss"]
    for term in terms:
        off = {term: 0.0}
        if term == "heat_uniform":
            off["cool_uniform"] = 0.0
        got = port_run(with_entropy(cfg, **off), fields, draws)
        diff = float((got["fields"]["ss"] - ref).abs().max())
        assert diff > 100 * RTOL_FIELD * float(ref.abs().max()), (term, diff)
