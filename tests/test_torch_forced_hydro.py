"""Forced hydro turbulence (the flagship without Magnetic) in
pencil_tpu_torch against pencil_tpu: the hydro instances of the flagship
template (K1h, K2h, K3h, K3′h, K2Lh; plain versions on the CPU) against
the Pallas kernels they replace, the fused chain against the JAX step at
the 2N-RK orders 2-4, the kernel constants, the gate and the state
converter.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode, with JAX's forcing draws injected through
``Model.forcing_draws``.  The JAX fused step fails at order 4 (a fault of
the reference, ROADMAP Queue 3), so the order-4 chain is held to the JAX
jnp path.  Bounds are those of tests/test_fused.py: each field within 2e-5
× its max, dt within 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import forced_hydro, shear_box
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_model import assert_states_close, jax_forcing_draws
from test_torch_rk_orders import assert_field_close

torch.set_num_threads(1)

N = 16
NSTEPS = 3
RTOL_DT = 1e-6


def config(pkg, n=N, itorder=3, fused=True, Omega=0.0, **time):
    cfg = forced_hydro(n, fused=fused, pkg=pkg, Omega=Omega)
    return dataclasses.replace(cfg, time=dataclasses.replace(
        cfg.time, itorder=itorder, **time))


def hydro_fields(shape, seed, z):
    """uu and lnrho as numpy, the same for both packages."""
    rng = np.random.default_rng(seed)
    return {
        "uu": (1e-2 * rng.standard_normal((3,) + shape)).astype(np.float32),
        "lnrho": (0.05 * np.sin(z)[None, None, :]
                  + 1e-3 * rng.standard_normal(shape)).astype(np.float32),
    }


def run_both(jcfg, pcfg, seed=11, nsteps=NSTEPS):
    """The JAX step and the port's step from the same fields, with the same
    forcing draws; returns both states."""
    jm, pm = pj.Model(jcfg), pt.Model(pcfg, device="cpu")
    fields = hydro_fields(jm.cfg.grid.shape, seed, pm.grid.z.numpy())
    js = jm.init_state(seed, overrides=fields)
    ps = pm.init_state(seed, overrides=fields)
    if pm.forcing is not None:
        pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"],
                                                  nsteps)).__next__
    jstep = jax.jit(jm.make_step())
    for _ in range(nsteps):
        js, ps = jstep(js), pm.make_step()(ps)
    return js, ps


# ---- the chain against the JAX step ----------------------------------------
@pytest.mark.parametrize("itorder", (3, 2), ids=("rk3", "rk2"))
def test_forced_hydro_matches_jax_fused(itorder):
    """Order 3 (K1h, K2h, K3h with the kick) and order 2 (K1h, K2Lh with
    the kick) against the JAX fused step, 3 forced steps."""
    js, ps = run_both(config(pj, itorder=itorder), config(pt, itorder=itorder))
    assert pt.Model(config(pt, itorder=itorder), device="cpu").mode == "wrap"
    assert_states_close(js, ps)


def test_forced_hydro_rk4_matches_jax_jnp_path():
    """Order 4 (K1h, K2h, K3′h twice, K3h) against the JAX jnp path, 3
    forced steps."""
    js, ps = run_both(config(pj, itorder=4, fused=False),
                      config(pt, itorder=4))
    assert_states_close(js, ps)


def test_packed_step_bit_identical_to_dict_step():
    pm = pt.Model(config(pt, n=8), device="cpu")
    a = pm.init_state(3)
    for _ in range(2):
        a = pm.make_step()(a)
    b = pm.make_multi_step(2)(pm.init_state(3))
    for key in ("t", "dt", "it"):
        assert torch.equal(a[key], b[key]), key
    for k in a["fields"]:
        assert torch.equal(a["fields"][k], b["fields"][k]), k


def test_forced_hydro_grows_urms():
    """Production draws: forcing 0.07 against 1e-3 noise raises urms; dt
    stays CFL-limited."""
    pm = pt.Model(config(pt), device="cpu")
    s = pm.init_state(0)
    u0 = float(s["fields"]["uu"].pow(2).sum(0).mean().sqrt())
    s = pm.make_multi_step(5)(s)
    u1 = float(s["fields"]["uu"].pow(2).sum(0).mean().sqrt())
    assert all(torch.isfinite(v).all() for v in s["fields"].values())
    assert u1 > u0
    assert 0.0 < float(s["dt"]) < pm.cfg.time.dtmax


# ---- the hydro instances against the Pallas kernels ------------------------
SHAPE = (8, 8, 16)


def noisy_fa(shape, seed):
    rng = np.random.default_rng(seed)
    amp = np.array([1e-2] * 3 + [5e-2])[:, None, None, None]
    return (amp * rng.standard_normal((4,) + shape)).astype(np.float32)


@pytest.fixture(scope="module")
def kernels():
    """Every wrap-mode call shape of the JAX package (interpret mode) built
    for the hydro set, on numpy inputs; numpy results."""
    jm = pj.Model(config(pj, n=SHAPE))
    pm = pt.Model(config(pt, n=SHAPE), device="cpu")
    fa, fa2 = noisy_fa(SHAPE, 3), noisy_fa(SHAPE, 4)
    z = jm.grid.z
    alpha, beta, _ = jm.rk
    df1, dt1 = jm._fused_rhs(SHAPE, False, True, False)(jnp.asarray(fa), z)
    dt = np.float32(1.0 / float(jnp.max(dt1)))
    out = dict(pm=pm, fa=fa, fa2=fa2, df1=np.asarray(df1),
               dt1max=float(jnp.max(dt1)))
    out["coef2"] = np.array([alpha[1], beta[1] * dt, beta[0] * dt],
                            np.float32)
    out["coef3"] = np.array([alpha[2], beta[2] * dt, 0.0], np.float32)
    df2, f2 = jm._fused_rhs(SHAPE, True, True, False, True, False, False)(
        jnp.asarray(fa), z, df1, alpha[1], beta[1] * dt, cprev=beta[0] * dt)
    out["df2"], out["f2"] = np.asarray(df2), np.asarray(f2)
    kick = jm.cfg.module("forcing").kick_coeffs(
        jax.random.PRNGKey(8), jnp.float32(dt), jm.cfg, jm.eos, jnp.float32)
    out["kick"] = np.concatenate([np.ravel(np.asarray(k)) for k in kick]
                                 + [np.zeros(1)]).astype(np.float32)
    for k in (None, kick):
        out["last", k is None] = np.asarray(jm._fused_rhs(
            SHAPE, True, True, False, False, True, k is not None)(
            f2, z, df2, alpha[2], beta[2] * dt, kick=k))
        out["defer_last", k is None] = np.asarray(jm._fused_rhs(
            SHAPE, True, True, False, True, True, k is not None)(
            jnp.asarray(fa2), z, df1, alpha[2], beta[2] * dt,
            cprev=beta[1] * dt, kick=k))
    # the order-4 middle substeps' call (kernel_upd with the wrap fetch)
    mid = jm._fused_rhs(SHAPE, True, True, False, False, False, False)
    df, f, _ = mid(jnp.asarray(fa2), z, df1, alpha[2], beta[2] * dt)
    out["mid"] = (np.asarray(df), np.asarray(f))
    return out


def test_rhs_first_hydro_matches_pallas(kernels):
    """K1h's plain version: df and the max 1/dt, with no Alfvén speed and
    ν alone in the diffusive rate."""
    df, dt1m = fr.rhs_first(kernels["pm"], torch.tensor(kernels["fa"]))
    assert df.shape == (4,) + SHAPE and dt1m.ndim == 0
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(4):
        assert_field_close(df[c], kernels["df1"][c], f"df1[{c}]")


def test_rhs_tail_defer_hydro_matches_pallas(kernels):
    """K2h's plain version: df2 and f2 from raw f0 and df1."""
    df2, f2 = fr.rhs_tail_defer(kernels["pm"], torch.tensor(kernels["fa"]),
                                torch.tensor(kernels["df1"]),
                                torch.tensor(kernels["coef2"]))
    for c in range(4):
        assert_field_close(df2[c], kernels["df2"][c], f"df2[{c}]")
        assert_field_close(f2[c], kernels["f2"][c], f"f2[{c}]")


@pytest.mark.parametrize("kicked", (False, True), ids=("unforced", "kick"))
def test_rhs_tail_last_hydro_matches_pallas(kernels, kicked):
    """K3h's plain version, with and without the helical kick."""
    kick = torch.tensor(kernels["kick"]) if kicked else None
    f3 = fr.rhs_tail_last(kernels["pm"], torch.tensor(kernels["f2"]),
                          torch.tensor(kernels["df2"]),
                          torch.tensor(kernels["coef3"]), kick)
    for c in range(4):
        assert_field_close(f3[c], kernels["last", not kicked][c], f"f3[{c}]")


@pytest.mark.parametrize("kicked", (False, True), ids=("unforced", "kick"))
def test_rhs_tail_defer_last_hydro_matches_pallas(kernels, kicked):
    """K2Lh's plain version: f rebuilt from raw f0 and df1, updated and
    kicked."""
    kick = torch.tensor(kernels["kick"]) if kicked else None
    coef = kernels["coef3"].copy()
    coef[2] = kernels["coef2"][1]
    f = fr.rhs_tail_defer_last(kernels["pm"], torch.tensor(kernels["fa2"]),
                               torch.tensor(kernels["df1"]),
                               torch.tensor(coef), kick)
    for c in range(4):
        assert_field_close(f[c], kernels["defer_last", not kicked][c],
                           f"f[{c}]")


def test_rhs_tail_mid_hydro_matches_pallas(kernels):
    """K3′h's plain version: df (written over df_prev) and f."""
    df_prev = torch.tensor(kernels["df1"])
    df, f = fr.rhs_tail_mid(kernels["pm"], torch.tensor(kernels["fa2"]),
                            df_prev, torch.tensor(kernels["coef3"]))
    assert df is df_prev
    for c in range(4):
        assert_field_close(df[c], kernels["mid"][0][c], f"df[{c}]")
        assert_field_close(f[c], kernels["mid"][1][c], f"f[{c}]")


# ---- the kernel constants -----------------------------------------------
def test_kernel_params_take_both_layouts():
    """The flagship template's constants for the 7-field MHD and the
    4-field hydro layouts, each with its library; η enters the diffusive
    rate only with Magnetic."""
    from test_torch_model import flagship
    mhd = pt.Model(flagship(pt, n=8), device="cpu")
    hyd = pt.Model(config(pt, n=8), device="cpu")
    assert fr.flagship_library(mhd) == "fused_rhs"
    assert fr.flagship_library(hyd) == "fused_rhs_hydro"
    pm, ph = fr.kernel_params(mhd), fr.kernel_params(hyd)
    assert (ph.nx, ph.ny, ph.nz) == (8, 8, 8)
    assert ph.eta == 0.0 and pm.eta == np.float32(5e-3)
    assert ph.dif == pm.dif          # ν = η = 5e-3: the same maximum
    assert list(ph.om) == list(pm.om) == [0.0, 0.0, 0.0]
    rot = pt.Model(config(pt, n=8, Omega=1.0), device="cpu")
    assert list(fr.kernel_params(rot).om) == [0.0, 0.0, 1.0]


@pytest.mark.parametrize("which", ("conv_slab", "shear_box", "entropy"))
def test_kernel_params_refuse_other_layouts(which):
    """Magnetoconvection on a fully periodic grid (uu, lnrho, ss, aa under
    gravity with the cooling and heating layers: the periodic builds take
    gravity, tests/test_torch_gravity_chains.py, but have no layer terms;
    the set without ss under gravity, the case here before, runs since),
    the shear box with an entropy field beside its shock slot under
    constant gravity with a cooling layer (uu, lnrho, ss, aa, shock: the
    template's shock and shear builds take that layout and gravity, but
    no layer; without the layer, the case here before, it runs) and an
    entropy slot with a cooling layer are not layouts and module sets of
    the flagship template's builds."""
    from pencil_tpu_torch.configs import conv_slab
    mag = conv_slab(8, magnetic=True)
    cfg = {"conv_slab": lambda: mag.replace(
               grid=pt.GridSpec(nx=8, ny=8, nz=8), bcz=()),
           "shear_box": lambda: shear_box(8).replace(modules=tuple(
               pt.EosIdealGas(gamma=5.0 / 3.0, cs0=1.0, cp=1.0)
               if m.name == "eos" else m for m in shear_box(8).modules)
               + (pt.Entropy(iheatcond=("chi-const",), chi=5e-3, cool=15.0,
                             cs2cool=1.0),
                  pt.Gravity(gravz_profile="const", gravz=-1.0))),
           "entropy": lambda: config(pt, n=8).replace(
               modules=config(pt, n=8).modules + (
                   pt.Entropy(cool=15.0, cs2cool=1.0),))}[which]()
    pm = pt.Model(dataclasses.replace(cfg, fused=False), device="cpu")
    with pytest.raises(NotImplementedError, match="layout"):
        fr.kernel_params(pm)


# ---- the gate -----------------------------------------------------------
@pytest.mark.parametrize("itorder", (1, 2, 3, 4))
@pytest.mark.parametrize("variant", ("forced", "unforced", "rotating"))
def test_gate_accepts_hydro(variant, itorder):
    """Forced hydro, without forcing and with Ω, at every 2N-RK order, runs
    the wrap chain on the card and on the CPU."""
    cfg = config(pt, itorder=itorder, Omega=1.0 if variant == "rotating"
                 else 0.0)
    if variant == "unforced":
        cfg = cfg.replace(modules=cfg.modules[:-1])
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    assert pt.Model(cfg, device="cpu").mode == "wrap"


def test_fake_rhs_refuses_hydro():
    """K8 is built for the MHD flagship only."""
    with pytest.raises(NotImplementedError):
        pt.Model(config(pt, dt=1e-3), fake_rhs=True, device="cpu")


# ---- the state converter ------------------------------------------------
def test_jax_forced_hydro_state_converts():
    """A JAX forced-hydro state (uu, lnrho) crosses as numpy through
    overrides_from_numpy and starts the port's state bit for bit."""
    jm = pj.Model(config(pj, n=8))
    pm = pt.Model(config(pt, n=8), device="cpu")
    js = jm.init_state(4)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    over = overrides_from_numpy(fields, pm.reg)
    assert sorted(over) == ["lnrho", "uu"]
    ps = pm.init_state(4, overrides=over)
    for k, v in fields.items():
        np.testing.assert_array_equal(ps["fields"][k].numpy(), v, k)
    with pytest.raises(KeyError):
        overrides_from_numpy({"uu": fields["uu"]}, pm.reg)
