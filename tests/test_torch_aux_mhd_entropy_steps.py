"""Three steps of non-isothermal MHD shock turbulence and of the MHD
shearing box with an entropy field in pencil_tpu_torch against
pencil_tpu: ``shock_box(n, entropy=True)`` (9 slots) through the port's
wrap_aux chain against the JAX fused step (wrap mode with the shock slot),
and ``shear_box(n, entropy=True[, shock=False])`` through the port's
zroll chain against the JAX fused zroll step (Pallas interpret mode), each
at 16³ and 8×16×24, with Ω and del6 hyper-diffusion as the shear boxes
have them (the ROT and H3 instances on the card).  The layout without the
shock slot, and each layout through the port's eager path against the
JAX jnp path at 16³, are in tests/test_torch_aux_mhd_entropy_ns_steps.py,
so that the two files share the cost.

Both packages start from the JAX initial fields with s replaced by numpy
noise of 1e-2 (and, in the shocked box, u at urms ≈ 1e-1 and lnρ at 1e-2),
so that the entropy terms are of the size of the others; the shocked box,
which is forced, sees the same forcing draws (JAX's, injected through
``Model.forcing_draws``), the shear boxes are unforced.  The shear boxes
start at t = 0.37, where deltay = 0.555·Ly is not a whole number of
cells.  Bounds are those of tests/test_fused.py: each field within 2e-5 ×
its max, dt within 1e-6 relative.  ``jax_steps`` answers the JAX fused
step's wrap-tail predicate as the zroll mode would for a shear box without
an aux slot (``zroll_tails``; tests/test_torch_aux_mhd_entropy_ns_steps.py
says why).
"""
import jax
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from test_torch_aux_entropy import config, is_shock_box
from test_torch_aux_entropy_steps import assert_field_close
from test_torch_model import jax_forcing_draws
from test_torch_shear_layout_steps import spy_fused_rhs, zroll_tails

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
TSTART = 0.37
NSTEPS = 3
URMS = 1e-1
# (layout, shape, JAX path): the fused step at two shapes
CASES = [(lay, shape, True) for lay in ("mhd_shock", "mhd_shear")
         for shape in ((16, 16, 16), (8, 16, 24))]


def case_id(case):
    lay, shape, fused = case
    return f"{lay}-{'x'.join(map(str, shape))}-{'fused' if fused else 'jnp'}"


def initial_overrides(layout, shape, seed):
    """s of numpy noise at 1e-2, and in the shocked box u at urms ≈ 1e-1
    and lnρ at 1e-2 (its initial u is the configuration's 1e-2 noise)."""
    rng = np.random.default_rng(seed)
    over = {"ss": (1e-2 * rng.standard_normal(shape)).astype(np.float32)}
    if is_shock_box(layout):
        over["uu"] = (URMS / np.sqrt(3.0) * rng.standard_normal(
            (3,) + shape)).astype(np.float32)
        over["lnrho"] = (1e-2 * rng.standard_normal(shape)).astype(
            np.float32)
    return over


def jax_steps(layout, shape, fused):
    """NSTEPS steps of the JAX fused or jnp path from init_state(5) with
    the overrides; numpy results, the initial fields and the forcing draws
    each step made (None for an unforced run)."""
    jm = pj.Model(config(pj, layout, shape, fused))
    calls = []
    if fused:
        if is_shock_box(layout):
            assert jm._fused_mode(None, None, shape[2]) == "wrap"
            want = {(False, True, False), (True, True, False)}
        else:
            sdy = jm.cfg.module("shear").deltay(
                jax.numpy.float32(TSTART), jm.cfg.grid.Lx, jm.cfg.grid.Ly)
            assert jm._fused_mode(None, sdy, shape[2]) == "zroll"
            if not jm._aux_modules:
                zroll_tails(jm)
            want = {(False, False, False), (True, False, False)}
        spy_fused_rhs(jm, calls)
    js = jm.init_state(5, overrides=initial_overrides(layout, shape, 11))
    init = {k: np.asarray(v) for k, v in js["fields"].items()}
    draws = (jax_forcing_draws(jm, js["key"], NSTEPS)
             if jm.cfg.module("forcing") is not None else None)
    step = jax.jit(jm.make_step())
    for _ in range(NSTEPS):
        js = step(js)
    # the chain: the first kernel, then the update (the ones the step built)
    assert set(calls) == (want if fused else set())
    return dict(layout=layout, shape=shape, fused=fused, init=init,
                draws=draws, t=float(js["t"]), dt=float(js["dt"]),
                it=int(js["it"]),
                fields={k: np.asarray(v) for k, v in js["fields"].items()})


def check_port_steps(case):
    """The port's chain (``fused``: plain K1se/K5wse, K4e/K5e or K4ne/K5ne
    on the CPU, the shocked box's kick after the step) or eager path from
    JAX's initial fields against the same JAX path: dt, t, it and every
    evolved field, s and A among them; the state's shock slot, where the
    layout has one, is the last pre-pass's in both fused chains (the jnp
    path keeps its initial zero slot, held with the bound as an absolute
    value)."""
    layout, fused = case["layout"], case["fused"]
    pm = pt.Model(config(pt, layout, case["shape"], fused), device="cpu")
    assert pm.mode == (("wrap_aux" if is_shock_box(layout) else "zroll")
                       if fused else None)
    ps = pm.init_state(5, overrides=overrides_from_numpy(case["init"],
                                                         pm.reg))
    assert (case["draws"] is None) == (pm.forcing is None)
    if case["draws"] is not None:
        pm.forcing_draws = iter(case["draws"]).__next__
    step = pm.make_step()
    for _ in range(NSTEPS):
        ps = step(ps)
    np.testing.assert_allclose(float(ps["dt"]), case["dt"], rtol=RTOL_DT)
    np.testing.assert_allclose(float(ps["t"]), case["t"], rtol=RTOL_DT)
    assert int(ps["it"]) == case["it"]
    assert np.abs(case["fields"]["ss"]).max() > 1e-3
    assert np.abs(case["fields"]["aa"]).max() > 0.0
    for k, ref in case["fields"].items():
        if k != "shock":
            assert_field_close(ps["fields"][k], ref, k)
        elif fused:
            assert np.abs(ref).max() > 0.0
            assert_field_close(ps["fields"][k], ref, k)
        else:
            err = np.abs(ps["fields"][k].numpy() - ref).max()
            assert err <= RTOL_FIELD


@pytest.fixture(scope="module", params=CASES, ids=map(case_id, CASES))
def case(request):
    return jax_steps(*request.param)


def test_step_matches_jax(case):
    """The port's steps against JAX's (``check_port_steps``)."""
    check_port_steps(case)


@pytest.mark.parametrize("layout", ("mhd_shock", "mhd_shear",
                                    "mhd_shear_ns"))
def test_step_leaves_its_input_and_packs_bit_identically(layout):
    """The step never writes into its input, and a chunked multi-step
    equals the dict step bit for bit, forcing draws included."""
    pm = pt.Model(config(pt, layout, 8), device="cpu")
    packed = pm.pack_state(pm.init_state(3))
    before = packed["_fa"].clone()
    pm.make_step()(packed)
    assert torch.equal(packed["_fa"], before)
    pm = pt.Model(config(pt, layout, 8), device="cpu")
    a = pm.init_state(3)
    for _ in range(2):
        a = pm.make_step()(a)
    b = pm.make_multi_step(2)(pm.init_state(3))
    for key in ("t", "dt", "it"):
        assert torch.equal(a[key], b[key]), key
    for k in a["fields"]:
        assert torch.equal(a["fields"][k], b["fields"][k]), k


@pytest.mark.parametrize("layout", ("mhd_shock", "mhd_shear"))
def test_heating_raises_the_mean_entropy(layout):
    """The viscous heat (shock heating included) and the Ohmic heat raise
    the mean entropy of a run from s = 0 (conduction and advection
    conserve it)."""
    pm = pt.Model(config(pt, layout, 8), device="cpu")
    s = pm.make_multi_step(10)(pm.init_state(1))
    assert float(s["fields"]["ss"].mean()) > 0.0
