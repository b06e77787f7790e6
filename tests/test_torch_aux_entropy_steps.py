"""Three steps of non-isothermal supersonic turbulence and of the hydro
shear box with an entropy field in pencil_tpu_torch against pencil_tpu:
``shock_box(n, magnetic=False, entropy=True)`` through the port's wrap_aux
chain against the JAX fused step (wrap mode with the shock slot), and
``shear_box(n, magnetic=False, entropy=True[, shock=False])`` through the
port's zroll chain against the JAX fused zroll step (Pallas interpret
mode), each at 16³ and 8×16×24, with Ω and del6 hyper-diffusion as the
shear boxes have them (the ROT and H3 instances on the card); and each
through the port's eager path against the JAX jnp path at 16³.

Both packages start from the JAX initial fields with s replaced by numpy
noise of 1e-2 (and, in the shocked box, u at urms ≈ 1e-1 and lnρ at 1e-2),
so that the entropy terms are of the size of the others, and see the same
forcing draws (JAX's, injected through ``Model.forcing_draws``).  The shear
boxes start at t = 0.37, where deltay = 0.555·Ly is not a whole number of
cells.  Bounds are those of tests/test_fused.py: each field within 2e-5 ×
its max, dt within 1e-6 relative.

The JAX fused shear box without an aux slot takes the wrap mode's tail
kernels for its later substeps (a fault of the reference, ROADMAP Queue 3,
tests/test_torch_shear_layouts.py::
test_jax_fused_shear_box_without_aux_reference_fault): the layout without
the shock slot is held against the JAX fused step with that predicate
answered as the zroll mode would (``zroll_tails``), and against the jnp
path.
"""
import jax
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from test_torch_aux_entropy import config
from test_torch_model import jax_forcing_draws
from test_torch_shear_layout_steps import spy_fused_rhs, zroll_tails

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
TSTART = 0.37
NSTEPS = 3
URMS = 1e-1
# (layout, shape, JAX path): the fused step at two shapes and the jnp path
# at 16³
CASES = [(lay, shape, fused) for lay in ("shock", "shear", "shear_ns")
         for shape, fused in (((16, 16, 16), True), ((8, 16, 24), True),
                              ((16, 16, 16), False))]
IDS = [f"{lay}-{'x'.join(map(str, shape))}-{'fused' if fused else 'jnp'}"
       for lay, shape, fused in CASES]


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def initial_overrides(layout, shape, seed):
    """s of numpy noise at 1e-2, and in the shocked box u at urms ≈ 1e-1
    and lnρ at 1e-2 (its initial u is the configuration's 1e-2 noise)."""
    rng = np.random.default_rng(seed)
    over = {"ss": (1e-2 * rng.standard_normal(shape)).astype(np.float32)}
    if layout == "shock":
        over["uu"] = (URMS / np.sqrt(3.0) * rng.standard_normal(
            (3,) + shape)).astype(np.float32)
        over["lnrho"] = (1e-2 * rng.standard_normal(shape)).astype(
            np.float32)
    return over


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """NSTEPS steps of the JAX fused or jnp path from init_state(5) with
    the overrides; numpy results, the initial fields and the forcing draws
    each step made."""
    layout, shape, fused = request.param
    jm = pj.Model(config(pj, layout, shape, fused))
    calls = []
    if fused:
        if layout == "shock":
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
    draws = jax_forcing_draws(jm, js["key"], NSTEPS)
    step = jax.jit(jm.make_step())
    for _ in range(NSTEPS):
        js = step(js)
    # the chain: the first kernel, then the update (the ones the step built)
    assert set(calls) == (want if fused else set())
    return dict(layout=layout, shape=shape, fused=fused, init=init,
                draws=draws, t=float(js["t"]), dt=float(js["dt"]),
                it=int(js["it"]),
                fields={k: np.asarray(v) for k, v in js["fields"].items()})


def test_step_matches_jax(case):
    """The port's chain (``fused``: plain K1she/K5whe, K4he/K5he or
    K4hne/K5hne on the CPU, the kick after the step) or eager path from
    JAX's initial fields against the same JAX path: dt, t, it and every
    evolved field, s among them; the state's shock slot, where the layout
    has one, is the last pre-pass's in both fused chains (the jnp path
    keeps its initial zero slot, held with the bound as an absolute
    value)."""
    layout, fused = case["layout"], case["fused"]
    pm = pt.Model(config(pt, layout, case["shape"], fused), device="cpu")
    assert pm.mode == (("wrap_aux" if layout == "shock" else "zroll")
                       if fused else None)
    ps = pm.init_state(5, overrides=overrides_from_numpy(case["init"],
                                                         pm.reg))
    pm.forcing_draws = iter(case["draws"]).__next__
    step = pm.make_step()
    for _ in range(NSTEPS):
        ps = step(ps)
    np.testing.assert_allclose(float(ps["dt"]), case["dt"], rtol=RTOL_DT)
    np.testing.assert_allclose(float(ps["t"]), case["t"], rtol=RTOL_DT)
    assert int(ps["it"]) == case["it"]
    assert np.abs(case["fields"]["ss"]).max() > 1e-3
    for k, ref in case["fields"].items():
        if k != "shock":
            assert_field_close(ps["fields"][k], ref, k)
        elif fused:
            assert np.abs(ref).max() > 0.0
            assert_field_close(ps["fields"][k], ref, k)
        else:
            err = np.abs(ps["fields"][k].numpy() - ref).max()
            assert err <= RTOL_FIELD


@pytest.mark.parametrize("layout", ("shock", "shear", "shear_ns"))
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


@pytest.mark.parametrize("layout", ("shock", "shear"))
def test_heating_raises_the_mean_entropy(layout):
    """The viscous heat, shock heating included, raises the mean entropy
    of a forced run from s = 0 (conduction and advection conserve it)."""
    pm = pt.Model(config(pt, layout, 8), device="cpu")
    s = pm.make_multi_step(10)(pm.init_state(1))
    assert float(s["fields"]["ss"].mean()) > 0.0
