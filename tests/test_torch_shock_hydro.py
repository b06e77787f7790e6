"""Supersonic isothermal hydro turbulence with shock viscosity
(``configs.shock_box(n, magnetic=False)``: uu, lnrho and the shock slot) in
pencil_tpu_torch against pencil_tpu: K1sh and K5wh's plain versions
against the wrap-fetch Pallas kernels with the shock slot, traced for the
hydro set, three forced steps of the wrap_aux chain and of the eager path
against the JAX fused (wrap mode with an aux module) and jnp paths, each at
16³ and at 8×16×24, the shock term, the launches of the build, the state
carried from JAX, the gate and the configuration's defaults.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode; both shapes are ones where the JAX package
itself takes the wrap mode (ny % 8 == 0, nx >= 4).  Both packages start
from the same numpy fields with urms ≈ 1e-1 and see the same forcing draws
(JAX's, injected through ``Model.forcing_draws``).  Bounds are those of
tests/test_fused.py: each field within 2e-5 × its max, dt within 1e-6
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import (overrides_from_numpy,
                                             state_from_numpy,
                                             state_to_numpy)
from pencil_tpu_torch.configs import forced_entropy, shear_box, shock_box
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_march_builds import _Recorder, recorded  # noqa: F401
from test_torch_model import jax_forcing_draws

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
NSTEPS = 3
URMS = 1e-1
SHAPES = ((16, 16, 16), (8, 16, 24))
IDS = ("16^3", "8x16x24")
NAMES = ("rhs_wrap_shock_hydro", "rhs_wrap_shock_upd_hydro")


def config(pkg, shape, fused=True):
    return shock_box(shape, fused=fused, pkg=pkg, magnetic=False)


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def noisy_fa(shape, seed):
    """A 5-slot stack (uu, lnrho, shock) of numpy noise, urms ≈ URMS, with
    a positive shock slot."""
    rng = np.random.default_rng(seed)
    amp = np.array([URMS / np.sqrt(3.0)] * 3 + [1e-2])
    fa = amp[:, None, None, None] * rng.standard_normal((4,) + shape)
    shock = 5e-2 * rng.random((1,) + shape)
    return np.concatenate([fa, shock]).astype(np.float32)


# ---- K1sh and K5wh against the Pallas kernels -------------------------------
@pytest.fixture(scope="module", params=SHAPES, ids=IDS)
def kernels(request):
    """K1sh and K5wh of the JAX package (wrap fetch, interpret mode) on the
    raw 5-slot state, every result kept as numpy."""
    shape = request.param
    jm = pj.Model(config(pj, shape))
    pm = pt.Model(config(pt, shape), device="cpu")
    assert jm._fused_mode(None, None, shape[2]) == "wrap" and jm._aux_modules
    fa, fa2 = noisy_fa(shape, 6), noisy_fa(shape, 7)
    z = jm.grid.z
    df1, dt1 = jm._fused_rhs(shape, False, True, False)(jnp.asarray(fa), z)
    alpha, beta, _ = jm.rk
    dt = 1.0 / jnp.max(dt1)
    df2, f2, _ = jm._fused_rhs(shape, True, True, False)(
        jnp.asarray(fa2), z, df1, alpha[1], beta[1] * dt)
    return dict(pm=pm, shape=shape, fa=fa, fa2=fa2, df1=np.asarray(df1),
                dt1max=float(jnp.max(dt1)), dt=np.float32(dt),
                df2=np.asarray(df2), f2=np.asarray(f2))


def test_rhs_wrap_shock_hydro_matches_pallas(kernels):
    """K1sh's plain version: df and the max 1/dt over tiles."""
    pm = kernels["pm"]
    assert fr.aux_library(pm) == "fused_rhs_shock_hydro"
    df, dt1m = fr.rhs_wrap_shock(pm, torch.tensor(kernels["fa"]))
    assert dt1m.ndim == 0 and tuple(df.shape) == (4,) + kernels["shape"]
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(4):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_rhs_wrap_shock_upd_hydro_matches_pallas(kernels):
    """K5wh's plain version: df (written over df_prev) and f."""
    pm = kernels["pm"]
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = fr.rhs_wrap_shock_upd(pm, torch.tensor(kernels["fa2"]), df_prev,
                                  coef)
    assert df is df_prev
    assert tuple(f.shape) == (4,) + kernels["shape"]
    for c in range(4):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


def test_shock_term_is_live(kernels):
    """On these inputs ν_sh·shock exceeds ν where it matters: dropping the
    shock slot moves du by far more than the parity bound, and the CFL
    maximum with it (the shock diffusivity)."""
    pm, fa = kernels["pm"], kernels["fa"].copy()
    df, dt1m = fr.rhs_wrap_shock(pm, torch.tensor(fa))
    fa[4] = 0.0
    df0, dt1m0 = fr.rhs_wrap_shock(pm, torch.tensor(fa))
    err = float((df[:3] - df0[:3]).abs().max())
    assert err > 100 * RTOL_FIELD * float(df[:3].abs().max())
    assert float(dt1m) > (1 + 100 * RTOL_DT) * float(dt1m0)


# ---- three forced steps against the JAX paths -------------------------------
def initial_fields(jm, seed):
    rng = np.random.default_rng(seed)
    shape = jm.cfg.grid.shape
    return {
        "uu": (URMS / np.sqrt(3.0)
               * rng.standard_normal((3,) + shape)).astype(np.float32),
        "lnrho": (1e-2 * rng.standard_normal(shape)).astype(np.float32),
    }


@pytest.fixture(scope="module", params=SHAPES, ids=IDS)
def jax_runs(request):
    """The JAX fused (wrap mode with the shock slot, Pallas interpret) and
    jnp paths, NSTEPS steps each from the same initial fields; numpy
    results and the forcing draws each step made."""
    shape = request.param
    out = {"shape": shape}
    for fused in (True, False):
        jm = pj.Model(config(pj, shape, fused=fused))
        if fused:
            assert jm._fused_mode(None, None, shape[2]) == "wrap"
        js = jm.init_state(5, overrides=initial_fields(jm, 11))
        init = {k: np.asarray(v) for k, v in js["fields"].items()}
        draws = jax_forcing_draws(jm, js["key"], NSTEPS)
        step = jax.jit(jm.make_step())
        for _ in range(NSTEPS):
            js = step(js)
        out[fused] = dict(init=init, draws=draws, t=float(js["t"]),
                          dt=float(js["dt"]), it=int(js["it"]),
                          fields={k: np.asarray(v)
                                  for k, v in js["fields"].items()})
    return out


def run_port(shape, ref, fused):
    pm = pt.Model(config(pt, shape, fused=fused), device="cpu")
    assert pm.mode == ("wrap_aux" if fused else None)
    ps = pm.init_state(5, overrides=overrides_from_numpy(ref["init"], pm.reg))
    pm.forcing_draws = iter(ref["draws"]).__next__
    step = pm.make_step()
    for _ in range(NSTEPS):
        ps = step(ps)
    return ps


def assert_steps_close(ps, ref):
    np.testing.assert_allclose(float(ps["dt"]), ref["dt"], rtol=RTOL_DT)
    np.testing.assert_allclose(float(ps["t"]), ref["t"], rtol=RTOL_DT)
    assert int(ps["it"]) == ref["it"]
    for k in ("uu", "lnrho"):
        assert_field_close(ps["fields"][k], ref["fields"][k], k)


def test_wrap_aux_step_matches_jax_fused(jax_runs):
    """The port's wrap_aux chain on the hydro layout (plain K1sh/K5wh on
    the CPU, the kick after the step) against the JAX fused step; the
    state's shock slot is the last pre-pass's in both, and ν_sh·shock
    exceeds ν."""
    ref = jax_runs[True]
    ps = run_port(jax_runs["shape"], ref, fused=True)
    assert_steps_close(ps, ref)
    shock = ref["fields"]["shock"]
    nu, nu_shock, _ = config(pt, 8).module("viscosity").coefficients()
    assert nu_shock * np.abs(shock).max() > 10 * nu
    assert_field_close(ps["fields"]["shock"], shock, "shock")


def test_eager_step_matches_jax_jnp_path(jax_runs):
    """fused=False: the port's eager path against the JAX jnp path.  The
    jnp path writes the shock into its ghosted copy only, so the state
    keeps its initial (zero) shock slot: held with the bound as an
    absolute value."""
    ref = jax_runs[False]
    ps = run_port(jax_runs["shape"], ref, fused=False)
    assert_steps_close(ps, ref)
    err = np.abs(ps["fields"]["shock"].numpy() - ref["fields"]["shock"])
    assert err.max() <= RTOL_FIELD


def test_step_leaves_its_input_and_packs_bit_identically():
    """The packed step never writes into its input, and a chunked
    multi-step equals the dict step bit for bit, forcing draws included."""
    pm = pt.Model(config(pt, 8), device="cpu")
    a = pm.init_state(3)
    packed = pm.pack_state(a)
    before = packed["_fa"].clone()
    pm.make_step()(packed)
    assert torch.equal(packed["_fa"], before)
    pm = pt.Model(config(pt, 8), device="cpu")
    a = pm.init_state(3)
    for _ in range(2):
        a = pm.make_step()(a)
    b = pm.make_multi_step(2)(pm.init_state(3))
    for key in ("t", "dt", "it"):
        assert torch.equal(a[key], b[key]), key
    for k in a["fields"]:
        assert torch.equal(a["fields"][k], b["fields"][k]), k


# ---- the layout, the state from JAX and the build ---------------------------
def test_registry_layout_matches_jax():
    pm = pt.Model(config(pt, 8), device="cpu")
    jm = pj.Model(config(pj, 8))
    assert pm.reg.comp_names == jm.reg.comp_names == [
        "ux", "uy", "uz", "lnrho", "shock"]
    assert (pm.reg.nvar, pm.reg.ncom, pm.reg.nf) == (4, 5, 5)
    assert [m.name for m in pm.modules] == [m.name for m in jm.modules]


def test_state_from_jax_round_trips():
    """A JAX state of the hydro shock box becomes the port's, slot for
    slot in the JAX registration order, and goes back unchanged."""
    jm = pj.Model(config(pj, 8))
    js = jm.init_state(2, overrides=initial_fields(jm, 3))
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = state_from_numpy(fields, js["t"], js["dt"], js["it"], device="cpu")
    pm = pt.Model(config(pt, 8), device="cpu")
    assert set(ps["fields"]) == set(pm.reg.slots)
    assert list(pm.reg.slots) == list(jm.reg.slots) == ["uu", "lnrho",
                                                        "shock"]
    np.testing.assert_array_equal(pm.reg.stack(ps["fields"]).numpy(),
                                  np.asarray(jm.reg.stack(js["fields"])))
    back = state_to_numpy(ps)
    for k, v in fields.items():
        np.testing.assert_array_equal(back["fields"][k], v)
    over = overrides_from_numpy(fields, pm.reg)
    assert over["shock"].shape == (8, 8, 8) and over["uu"].shape[0] == 3


def test_wrappers_launch_the_hydro_shock_build(recorded):  # noqa: F811
    """K1sh and K5wh launch pc_rhs_first and pc_rhs_tail_mid of
    fused_rhs_shock_hydro on the periodic 5-slot state, counted under
    their own names; the 8-slot MHD state and the zroll wrappers are
    refused."""
    shape = (16, 16, 32)
    pm = pt.Model(config(pt, shape), device="cpu")
    fa = torch.zeros((5,) + shape)
    fr.rhs_wrap_shock(pm, fa)
    fr.rhs_wrap_shock_upd(pm, fa, torch.zeros((4,) + shape), torch.zeros(2))
    assert recorded == [("fused_rhs_shock_hydro", "pc_rhs_first"),
                        ("fused_rhs_shock_hydro", "pc_rhs_tail_mid")]
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               **dict.fromkeys(NAMES, 1))
    assert fr.launch_suffix(pm) == "_hydro"
    with pytest.raises(ValueError):
        fr.rhs_wrap_shock(pm, torch.zeros((8,) + shape))
    with pytest.raises(NotImplementedError):
        fr.rhs_zroll(pm, fa)


def test_kernel_params_have_no_magnetic_terms():
    """The hydro shock build's constants: ν_sh, no η, no del6 rate."""
    p = fr.kernel_params(pt.Model(config(pt, 8), device="cpu"))
    assert p.nu_shock == np.float32(1.0) and p.nu == np.float32(1e-3)
    assert p.eta == 0.0 and p.eta3 == 0.0 and p.dif3 == 0.0 and p.S == 0.0


# ---- the gate and the configuration ----------------------------------------
@pytest.mark.parametrize("forced", (True, False), ids=("forced", "unforced"))
def test_gate_accepts_the_hydro_shock_box(forced):
    cfg = config(pt, 16)
    if not forced:
        cfg = cfg.replace(modules=tuple(m for m in cfg.modules
                                        if m.name != "forcing"))
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    assert pt.Model(cfg, device="cpu").mode == "wrap_aux"


@pytest.mark.parametrize("magnetic", (True, False), ids=("mhd", "hydro"))
def test_a_shock_slot_beside_entropy_stays_refused(magnetic):
    """The MHD layouts with an entropy field on the shock and shear
    builds: non-isothermal MHD turbulence with shock viscosity (the
    flagship's entropy set with nu-shock and the Shock module, 9 slots)
    and (``magnetic=False``: the hydro layout with ss and the slot runs
    K1she/K5whe, tests/test_torch_aux_entropy.py) the shear box with ss
    and A without the slot (8 fields).  The gate admits each, on the card
    and on the CPU, in the mode of its chain, and its kernel constants
    come from its own build (K1se/K5wse, K4ne/K5ne)."""
    if magnetic:
        cfg = forced_entropy(8, magnetic=True)
        cfg = cfg.replace(modules=tuple(
            pt.Viscosity(ivisc=("nu-const", "nu-shock"), nu=5e-3,
                         nu_shock=1.0)
            if m.name == "viscosity" else m for m in cfg.modules)
            + (pt.Shock(),))
        mode, lib = "wrap_aux", "fused_rhs_shock_ent"
    else:
        cfg = shear_box(8, entropy=True, shock=False)
        mode, lib = "zroll", "fused_rhs_shear_ent_ns"
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode == mode
    assert fr.aux_library(pm) == lib
    p = fr.kernel_params(pm)
    assert p.eta > 0.0 and p.eta_heat == p.eta and p.cpchi > 0.0


@pytest.mark.parametrize("pkg", (pt, pj), ids=("port", "jax"))
def test_shock_box_defaults_to_magnetic(pkg):
    """``magnetic=True`` is the default, in both packages: the 8-slot MHD
    box of before; ``magnetic=False`` drops Magnetic and nothing else."""
    cfg = shock_box(16, pkg=pkg)
    assert cfg == shock_box(16, pkg=pkg, magnetic=True)
    assert [m.name for m in cfg.modules] == [
        "eos", "density", "hydro", "viscosity", "magnetic", "shock",
        "forcing"]
    assert cfg.module("magnetic").eta == 1e-3
    hyd = shock_box(16, pkg=pkg, magnetic=False)
    assert hyd.modules == tuple(m for m in cfg.modules
                                if m.name != "magnetic")
