"""Non-isothermal MHD shock turbulence and the MHD shearing box with an
entropy field in pencil_tpu_torch against pencil_tpu, kernel by kernel:
``shock_box(n, entropy=True)`` (uu, lnrho, ss, aa, shock: 9 slots),
``shear_box(n, entropy=True)`` (the same slots) and ``shear_box(n,
entropy=True, shock=False)`` (uu, lnrho, ss, aa: 8 fields).  K1se/K5wse,
K4e/K5e and K4ne/K5ne's plain versions against the wrap-fetch (with the
shock slot) and zroll Pallas kernels they replace, traced for each set, at
16³ and 8×16×24, with Ω and del6 hyper-diffusion as the shear boxes have
them; the Ohmic heat η·J²/(ρT) in ds shown on its own; the state carried
from JAX in the 9-slot and 8-field layouts.  The gate, the launches and
the kernel constants of these layouts are in
tests/test_torch_aux_entropy.py (``mhd_*`` layouts), their steps in
tests/test_torch_aux_mhd_entropy_steps.py.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode: the shocked box on its raw periodic state, the
shear boxes on x/y-ghosted inputs at t = 0.37, where deltay = 0.555·Ly is
not a whole number of cells.  Inputs are numpy noise from a seed: u at
urms ≈ 1e-1 (shocked box) or 1e-2, lnρ and s at 1e-2, A at 3e-2 (shocked
box, 2π cube) or 1e-3 (shear box, unit cube), so that the Lorentz force
and the Ohmic heat are of the size of the other terms, a positive shock
slot.  Bounds are those of tests/test_fused.py: each field within 2e-5 ×
its max, the CFL maximum within 1e-6 relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import (overrides_from_numpy,
                                             state_from_numpy,
                                             state_to_numpy)
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.physics.pencils import Pencils
from test_torch_aux_entropy import (LAYOUTS, assert_field_close, config,
                                    deltas, first_kernel, is_shock_box,
                                    j_ghosted)

torch.set_num_threads(1)

RTOL_DT = 1e-6
SHAPES = ((16, 16, 16), (8, 16, 24))
IDS = ("16^3", "8x16x24")
MHD = ("mhd_shock", "mhd_shear", "mhd_shear_ns")
NVAR = 8


def noisy_fa(layout, shape, seed):
    """A stack of the layout's slots of numpy noise: u at urms ≈ 1e-1 in
    the shocked box (1e-2 in the shear boxes), lnρ and s at 1e-2, A at
    3e-2 in the shocked box (1e-3 in the shear boxes), a positive shock
    slot."""
    rng = np.random.default_rng(seed)
    names = LAYOUTS[layout][3]
    shocked = is_shock_box(layout)
    amp = {"u": 1e-1 / np.sqrt(3.0) if shocked else 1e-2,
           "l": 1e-2, "s": 1e-2, "a": 3e-2 if shocked else 1e-3}
    out = [amp[c[0]] * rng.standard_normal(shape) for c in names
           if c != "shock"]
    if "shock" in names:
        out.append((5e-2 if shocked else 1e-3) * rng.random(shape))
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module", params=[(lay, s) for lay in MHD
                                        for s in SHAPES],
                ids=[f"{lay}-{i}" for lay in MHD for i in IDS])
def kernels(request):
    """The first and update Pallas kernels of the JAX package, traced for
    the layout (interpret mode): the wrap fetch on the raw state for the
    shocked box, the zroll fetch on x/y-ghosted inputs with shifted x faces
    for the shear boxes; numpy results."""
    layout, shape = request.param
    jm = pj.Model(config(pj, layout, shape))
    pm = pt.Model(config(pt, layout, shape), device="cpu")
    wrap = is_shock_box(layout)
    fa, fa2 = noisy_fa(layout, shape, 6), noisy_fa(layout, shape, 7)
    if wrap:
        assert jm._fused_mode(None, None, shape[2]) == "wrap"
        assert jm._aux_modules
    else:
        dj, _ = deltas(jm, pm)
        assert jm._fused_mode(None, dj, shape[2]) == "zroll"
        fa, fa2 = j_ghosted(jm, fa, dj), j_ghosted(jm, fa2, dj)
    z = jm.grid.z
    df1, dt1 = jm._fused_rhs(shape, False, wrap, False)(jnp.asarray(fa), z)
    alpha, beta, _ = jm.rk
    dt = 1.0 / jnp.max(dt1)
    df2, f2, _ = jm._fused_rhs(shape, True, wrap, False)(
        jnp.asarray(fa2), z, df1, alpha[1], beta[1] * dt)
    return dict(layout=layout, shape=shape, pm=pm, fa=fa, fa2=fa2,
                df1=np.asarray(df1), dt1max=float(jnp.max(dt1)),
                dt=np.float32(dt), df2=np.asarray(df2), f2=np.asarray(f2))


def test_first_kernel_matches_pallas(kernels):
    """K1se, K4e or K4ne's plain version: df and the max 1/dt over
    tiles."""
    pm = kernels["pm"]
    assert fr.aux_library(pm) == LAYOUTS[kernels["layout"]][2]
    first, _ = first_kernel(kernels["layout"])
    df, dt1m = first(pm, torch.tensor(kernels["fa"]))
    assert dt1m.ndim == 0 and tuple(df.shape) == (NVAR,) + kernels["shape"]
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(NVAR):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_update_kernel_matches_pallas(kernels):
    """K5wse, K5e or K5ne's plain version: df (written over df_prev) and
    f."""
    pm = kernels["pm"]
    _, upd = first_kernel(kernels["layout"])
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = upd(pm, torch.tensor(kernels["fa2"]), df_prev, coef)
    assert df is df_prev
    assert tuple(f.shape) == (NVAR,) + kernels["shape"]
    for c in range(NVAR):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


def test_ohmic_heating_shows_alone(kernels):
    """The Ohmic heat moves ds by η·J²/(ρT) (Magnetic publishes η·J²,
    Entropy divides by ρT, pencil_tpu/physics/entropy.py), within the
    bound of ds, and by more than 10 times that bound: the same kernel
    with ``lohmic_heat=False`` is the rest of ds."""
    pm = kernels["pm"]
    cold = pt.Model(pm.cfg.replace(modules=tuple(
        dataclasses.replace(m, lohmic_heat=False) if m.name == "magnetic"
        else m for m in pm.cfg.modules)), device="cpu")
    assert fr.kernel_params(cold).eta_heat == 0.0
    assert fr.kernel_params(pm).eta_heat == fr.kernel_params(pm).eta > 0.0
    first, _ = first_kernel(kernels["layout"])
    fa = torch.tensor(kernels["fa"])
    ss = pm.reg.slice("ss").start
    ds_full = first(pm, fa)[0][ss]
    ds = ds_full - first(cold, fa)[0][ss]
    zroll = not is_shock_box(kernels["layout"])
    pen = Pencils(fa, pm.grid, pm.reg, pm.cfg, pm.eos, wrap_z=zroll)
    eta = pm.cfg.module("magnetic").eta
    want = eta * pen.j2() * pen.rho1() * pen.TT1()
    bound = 2e-5 * float(ds_full.abs().max())
    assert float((ds - want).abs().max()) <= bound
    assert float(want.abs().max()) > 10 * bound


@pytest.mark.parametrize("layout", ("mhd_shock", "mhd_shear_ns"))
def test_state_from_jax_round_trips(layout):
    """A JAX state of the 9-slot (with the shock slot) and the 8-field
    layout becomes the port's through compat.from_jax, slot for slot in
    the JAX registration order (ss between lnrho and aa), and goes back
    unchanged; its fields start the port's state bit for bit."""
    jm = pj.Model(config(pj, layout, 8))
    rng = np.random.default_rng(3)
    over = {"ss": (1e-2 * rng.standard_normal((8, 8, 8))).astype(np.float32)}
    js = jm.init_state(2, overrides=over)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = state_from_numpy(fields, js["t"], js["dt"], js["it"], device="cpu")
    pm = pt.Model(config(pt, layout, 8), device="cpu")
    assert set(ps["fields"]) == set(pm.reg.slots)
    stack = pm.reg.stack(ps["fields"]).numpy()
    np.testing.assert_array_equal(stack,
                                  np.asarray(jm.reg.stack(js["fields"])))
    assert stack.shape[0] == len(LAYOUTS[layout][3])
    np.testing.assert_array_equal(stack[4], fields["ss"])
    np.testing.assert_array_equal(stack[5:8], fields["aa"])
    back = state_to_numpy(ps)
    for k, v in fields.items():
        np.testing.assert_array_equal(back["fields"][k], v)
    s = pm.init_state(0, overrides=overrides_from_numpy(fields, pm.reg))
    for k, v in fields.items():
        np.testing.assert_array_equal(s["fields"][k].numpy(), v)
    assert float(np.abs(fields["aa"]).max()) > 0.0
