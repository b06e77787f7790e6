"""Three steps of the shear box's other isothermal layouts in
pencil_tpu_torch against pencil_tpu: the MRI shearing box without shock
viscosity (``shear_box(n, shock=False)``), and the forced hydro shearing
box with and without it (``shear_box(n, magnetic=False[, shock=False])``),
each through the port's zroll chain (plain K4/K5 of its build on the CPU,
the forcing kick after the step) against the JAX fused zroll step (Pallas
interpret mode) at 16³ and 8×16×24, with Ω and del6 hyper-diffusion as the
configurations have them (the ROT and H3 instances on the card) and
without both (the plain instances), and through the port's eager path
against the JAX jnp path at 16³.

Every run starts at t = 0.37, where deltay = 0.555·Ly is not a whole
number of cells (at t = 0 the shifted faces are plain wraps), from JAX's
initial fields, with JAX's forcing draws injected through
``Model.forcing_draws``.  Bounds are those of tests/test_fused.py: each
field within 2e-5 × its max, dt within 1e-6 relative.

A fault of the reference: without an aux slot, the JAX fused step of a
shear box takes the wrap mode's deferred tail kernels for substeps 2 and 3
(pencil_tpu/model.py:662-665 asks ``_fused_mode`` with no shear offset),
so those substeps read plain periodic x faces, not the shifted ones.  The
layouts without the shock slot are therefore held against the JAX fused
step with that predicate answered as the zroll mode would (``zroll_tails``:
its zroll update kernels on the shifted faces, the chain the JAX package
runs with a shock slot), and the fault itself is recorded by
tests/test_torch_shear_layouts.py::
test_jax_fused_shear_box_without_aux_reference_fault.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import shear_box
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_model import jax_forcing_draws

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
TSTART = 0.37
NSTEPS = 3
LAYOUTS = {"mhd_ns": dict(shock=False), "hydro": dict(magnetic=False),
           "hydro_ns": dict(magnetic=False, shock=False)}
# (layout, shape, instances, JAX path): the configurations' Ω and del6
# terms ("rot_h3") at two shapes against the fused step and at 16³ against
# the jnp path, and neither ("still") against the fused step
CASES = [(lay, shape, inst, fused)
         for lay in LAYOUTS
         for shape, inst, fused in (((16, 16, 16), "rot_h3", True),
                                    ((8, 16, 24), "rot_h3", True),
                                    ((16, 16, 16), "still", True),
                                    ((16, 16, 16), "rot_h3", False))]
IDS = [f"{lay}-{'x'.join(map(str, shape))}-{inst}-"
       f"{'fused' if fused else 'jnp'}" for lay, shape, inst, fused in CASES]


def config(pkg, layout, shape, inst="rot_h3", fused=True):
    """The layout's configuration from t = TSTART; ``inst`` "still" drops
    Coriolis and every del6 coefficient (the instances without ROT and
    H3)."""
    cfg = shear_box(shape, fused=fused, pkg=pkg, **LAYOUTS[layout])
    cfg = dataclasses.replace(cfg, time=pkg.TimeSpec(itorder=3,
                                                      tstart=TSTART))
    if inst == "rot_h3":
        return cfg
    drop = {"hydro": dict(Omega=0.0), "density": dict(diffrho_hyper3=0.0),
            "magnetic": dict(eta_hyper3=0.0),
            "viscosity": dict(nu_hyper3=0.0, ivisc=tuple(
                v for v in cfg.module("viscosity").ivisc
                if v != "hyper3-simplified"))}
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, **drop[m.name]) if m.name in drop else m
        for m in cfg.modules))


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def zroll_tails(jm):
    """``jm`` with ``_fused_mode`` answering 'zroll' where it would answer
    'wrap': the wrap-tail predicate of its step (pencil_tpu/model.py:
    662-665) then keeps the zroll update kernels on the shifted faces.
    The JAX package itself is not changed; only this model instance."""
    mode = jm._fused_mode

    def fused_mode(names, shear_dy, nzl):
        m = mode(names, shear_dy, nzl)
        return "zroll" if m == "wrap" else m

    jm._fused_mode = fused_mode
    return jm


def spy_fused_rhs(jm, calls):
    """Record the flags (update, wrap, zghost) of each fused kernel that
    ``jm``'s step builds."""
    build = jm._fused_rhs

    def spy(shape, *flags, **kw):
        calls.append(flags[:3])
        return build(shape, *flags, **kw)

    jm._fused_rhs = spy


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """NSTEPS steps of the JAX fused (zroll, Pallas interpret) or jnp path
    from init_state(5); numpy results, the initial fields and the forcing
    draws each step made."""
    layout, shape, inst, fused = request.param
    jm = pj.Model(config(pj, layout, shape, inst, fused))
    calls = []
    if fused:
        sdy = jm.cfg.module("shear").deltay(
            jax.numpy.float32(TSTART), jm.cfg.grid.Lx, jm.cfg.grid.Ly)
        assert jm._fused_mode(None, sdy, shape[2]) == "zroll"
        if not jm._aux_modules:
            zroll_tails(jm)
        spy_fused_rhs(jm, calls)
    js = jm.init_state(5)
    init = {k: np.asarray(v) for k, v in js["fields"].items()}
    draws = (jax_forcing_draws(jm, js["key"], NSTEPS)
             if jm.cfg.module("forcing") is not None else None)
    step = jax.jit(jm.make_step())
    for _ in range(NSTEPS):
        js = step(js)
    # the zroll chain: K4, then K5 (the kernels that the step built)
    assert set(calls) == ({(False, False, False), (True, False, False)}
                          if fused else set())
    return dict(layout=layout, shape=shape, inst=inst, fused=fused,
                init=init, draws=draws, t=float(js["t"]), dt=float(js["dt"]),
                it=int(js["it"]),
                fields={k: np.asarray(v) for k, v in js["fields"].items()})


def test_step_matches_jax(case):
    """The port's zroll chain (``fused``) or eager path from JAX's initial
    fields against the same JAX path: dt, t, it and every evolved field;
    the state's shock slot, where the layout has one, is the last
    pre-pass's in both fused chains (the jnp path keeps its initial zero
    slot, held with the bound as an absolute value)."""
    pm = pt.Model(config(pt, case["layout"], case["shape"], case["inst"],
                         case["fused"]), device="cpu")
    assert pm.mode == ("zroll" if case["fused"] else None)
    if case["fused"]:
        p = fr.kernel_params(pm)
        rot = any(p.om)
        h3 = p.nu3 > 0.0 and p.diff3 > 0.0
        assert (rot, h3) == ((True, True) if case["inst"] == "rot_h3"
                             else (False, False))
    ps = pm.init_state(5, overrides=overrides_from_numpy(case["init"],
                                                         pm.reg))
    if case["draws"] is not None:
        pm.forcing_draws = iter(case["draws"]).__next__
    step = pm.make_step()
    for _ in range(NSTEPS):
        ps = step(ps)
    np.testing.assert_allclose(float(ps["dt"]), case["dt"], rtol=RTOL_DT)
    np.testing.assert_allclose(float(ps["t"]), case["t"], rtol=RTOL_DT)
    assert int(ps["it"]) == case["it"]
    for k, ref in case["fields"].items():
        if k != "shock":
            assert_field_close(ps["fields"][k], ref, k)
        elif case["fused"]:
            assert np.abs(ref).max() > 0.0
            assert_field_close(ps["fields"][k], ref, k)
        else:
            err = np.abs(ps["fields"][k].numpy() - ref).max()
            assert err <= RTOL_FIELD


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_step_leaves_its_input_and_packs_bit_identically(layout):
    """The zroll step never writes into its input, with or without the
    shock slot, and a chunked multi-step equals the dict step bit for bit,
    forcing draws included."""
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


@pytest.mark.parametrize("layout", ("hydro", "hydro_ns"))
def test_forcing_drives_the_hydro_shear_box(layout):
    """The hydro shear box is forced: ten steps from rest (u = 0, lnρ = 0)
    raise urms, which the shear alone cannot."""
    pm = pt.Model(config(pt, layout, 8), device="cpu")
    s = pm.init_state(1, overrides={
        "uu": np.zeros((3, 8, 8, 8), np.float32),
        "lnrho": np.zeros((8, 8, 8), np.float32)})
    s = pm.make_multi_step(10)(s)
    assert float(s["fields"]["uu"].pow(2).sum(0).mean().sqrt()) > 1e-3

