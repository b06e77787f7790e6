"""The shear box's other isothermal layouts in pencil_tpu_torch against
pencil_tpu, kernel by kernel: the MRI shearing box without shock viscosity
(``shear_box(n, shock=False)``: uu, lnrho, aa), and the forced hydro
shearing box with and without it (``shear_box(n, magnetic=False)``: uu,
lnrho, shock; ``shear_box(n, magnetic=False, shock=False)``: uu, lnrho).
K4n/K5n, K4h/K5h and K4hn/K5hn's plain versions against the zroll Pallas
kernels they replace, traced for each set, at 16³ and 8×16×24; the shear
and shock terms; the launches of each build; the registry against JAX's
and the state carried from it; the gate and the configuration's
defaults; and a fault of the reference's fused step without an aux
slot.  Steps are in tests/test_torch_shear_layout_steps.py.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode, on x/y-ghosted inputs at t = 0.37, where
deltay = 0.555·Ly is not a whole number of cells.  Bounds are those of
tests/test_fused.py: each field within 2e-5 × its max, dt within 1e-6
relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.parallel.halo import fill_ghosts as j_fill_ghosts
from pencil_tpu_torch.compat.from_jax import (overrides_from_numpy,
                                             state_from_numpy,
                                             state_to_numpy)
from pencil_tpu_torch.configs import shear_box
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.ops.stencil import NGHOST
import test_torch_shear_layout_steps as steps
from test_torch_march_builds import _Recorder, recorded  # noqa: F401

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
TSTART = 0.37
SHAPES = ((16, 16, 16), (8, 16, 24))
IDS = ("16^3", "8x16x24")
# each layout: the configuration's keyword arguments, its build, its
# slots and the suffix of its launch names
LAYOUTS = {
    "mhd_ns": (dict(shock=False), "fused_rhs_shear_ns",
               ["ux", "uy", "uz", "lnrho", "ax", "ay", "az"], "_ns"),
    "hydro": (dict(magnetic=False), "fused_rhs_shear_hydro",
              ["ux", "uy", "uz", "lnrho", "shock"], "_hydro"),
    "hydro_ns": (dict(magnetic=False, shock=False),
                 "fused_rhs_shear_hydro_ns", ["ux", "uy", "uz", "lnrho"],
                 "_hydro_ns"),
}


def config(pkg, layout, shape=16, fused=True):
    cfg = shear_box(shape, fused=fused, pkg=pkg, **LAYOUTS[layout][0])
    return dataclasses.replace(
        cfg, time=pkg.TimeSpec(itorder=3, tstart=TSTART))


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def noisy_fa(names, shape, seed):
    """A stack of the layout's slots of numpy noise: u and lnρ at 1e-2, A
    at 1e-4, a positive shock slot."""
    rng = np.random.default_rng(seed)
    amp = {"lnrho": 1e-2, "ax": 1e-4, "ay": 1e-4, "az": 1e-4}
    out = [amp.get(c, 1e-2) * rng.standard_normal(shape) for c in names
           if c != "shock"]
    if "shock" in names:
        out.append(1e-3 * rng.random(shape))
    return np.stack(out).astype(np.float32)


def deltas(jm, pm, t=TSTART):
    gs = jm.cfg.grid
    dj = jm.cfg.module("shear").deltay(jnp.float32(t), gs.Lx, gs.Ly)
    dp = pm.deltay(torch.tensor(t, dtype=torch.float32))
    return dj, dp


def j_ghosted(jm, fa, sdy):
    return np.asarray(j_fill_ghosts(
        jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg, jm.grid, jm.cfg,
        jm.eos, axes=(0, 1), shear_dy=sdy))


# ---- K4 and K5 of each layout against the Pallas kernels --------------------
@pytest.fixture(scope="module", params=[(lay, s) for lay in LAYOUTS
                                        for s in SHAPES],
                ids=[f"{lay}-{i}" for lay in LAYOUTS for i in IDS])
def kernels(request):
    """K4 and K5 of the JAX package, traced for the layout (interpret
    mode), on x/y-ghosted inputs with shifted x faces; numpy results."""
    layout, shape = request.param
    jm = pj.Model(config(pj, layout, shape))
    pm = pt.Model(config(pt, layout, shape), device="cpu")
    dj, _ = deltas(jm, pm)
    assert jm._fused_mode(None, dj, shape[2]) == "zroll"
    names = LAYOUTS[layout][2]
    fg = j_ghosted(jm, noisy_fa(names, shape, 6), dj)
    z = jm.grid.z
    df1, dt1 = jm._fused_rhs(shape, False, False, False)(jnp.asarray(fg), z)
    alpha, beta, _ = jm.rk
    dt = 1.0 / jnp.max(dt1)
    fg2 = j_ghosted(jm, noisy_fa(names, shape, 7), dj)
    df2, f2, _ = jm._fused_rhs(shape, True, False, False)(
        jnp.asarray(fg2), z, df1, alpha[1], beta[1] * dt)
    return dict(layout=layout, shape=shape, pm=pm, fg=fg, fg2=fg2,
                df1=np.asarray(df1), dt1max=float(jnp.max(dt1)),
                dt=np.float32(dt), df2=np.asarray(df2), f2=np.asarray(f2))


def test_rhs_zroll_matches_pallas(kernels):
    """K4n, K4h or K4hn's plain version: df and the max 1/dt over tiles."""
    pm = kernels["pm"]
    assert fr.aux_library(pm) == LAYOUTS[kernels["layout"]][1]
    df, dt1m = fr.rhs_zroll(pm, torch.tensor(kernels["fg"]))
    nvar = pm.reg.nvar
    assert dt1m.ndim == 0 and tuple(df.shape) == (nvar,) + kernels["shape"]
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(nvar):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_rhs_zroll_upd_matches_pallas(kernels):
    """K5n, K5h or K5hn's plain version: df (written over df_prev) and
    f = the interior of fg + βΔt·df."""
    pm = kernels["pm"]
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = fr.rhs_zroll_upd(pm, torch.tensor(kernels["fg2"]), df_prev, coef)
    assert df is df_prev
    assert tuple(f.shape) == (pm.reg.nvar,) + kernels["shape"]
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


def _with_module(cfg, name, new):
    return cfg.replace(modules=tuple(new if m.name == name else m
                                     for m in cfg.modules))


def test_shear_terms_act(kernels):
    """The shear terms (−S x ∂/∂y of every field, −S u_x on u_y, and with
    A −S A_y on A_x) and |S x|/Δy in the CFL act in each layout: with
    q = 0 the same input gives a df far outside the bound and a CFL
    maximum outside ten times its bound (at 8×16×24 the del6 rate of the
    coarse x dominates it)."""
    pm = kernels["pm"]
    flat = pt.Model(_with_module(pm.cfg, "shear",
                                 pt.Shear(Omega=1.0, qshear=0.0)),
                    device="cpu")
    assert fr.kernel_params(flat).S == 0.0 and fr.kernel_params(pm).S != 0.0
    fg = torch.tensor(kernels["fg"])
    df, dt1m = fr.rhs_zroll(pm, fg)
    df0, dt1m0 = fr.rhs_zroll(flat, fg)
    for c in range(pm.reg.nvar):
        err = float((df[c] - df0[c]).abs().max())
        assert err > 100 * RTOL_FIELD * float(df[c].abs().max()), c
    assert float(dt1m) > (1 + 10 * RTOL_DT) * float(dt1m0)


def test_shock_term_acts_in_the_hydro_shear_box(kernels):
    """Where the layout has the shock slot, dropping it moves du (the
    shock viscosity); without it the build has no shock term to drop."""
    if "shock" not in LAYOUTS[kernels["layout"]][2]:
        assert fr.kernel_params(kernels["pm"]).nu_shock == 0.0
        return
    pm, fg = kernels["pm"], kernels["fg"].copy()
    df, _ = fr.rhs_zroll(pm, torch.tensor(fg))
    fg[4] = 0.0
    df0, _ = fr.rhs_zroll(pm, torch.tensor(fg))
    err = float((df[:3] - df0[:3]).abs().max())
    assert err > 10 * RTOL_FIELD * float(df[:3].abs().max())


# ---- the builds, the layout and the gate -----------------------------------
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_wrappers_launch_the_layouts_build(recorded, layout):  # noqa: F811
    """K4 and K5 launch pc_rhs_first and pc_rhs_tail_mid of the layout's
    build on its x/y-ghosted stack, counted under the launch names with
    its suffix; the unghosted state and the wrap_aux wrappers are
    refused."""
    shape = (16, 16, 32)
    pm = pt.Model(config(pt, layout, shape), device="cpu")
    _, lib, names, sfx = LAYOUTS[layout]
    nf, nvar = len(names), pm.reg.nvar
    g2 = 2 * NGHOST
    fg = torch.zeros((nf, shape[0] + g2, shape[1] + g2, shape[2]))
    fr.rhs_zroll(pm, fg)
    fr.rhs_zroll_upd(pm, fg, torch.zeros((nvar,) + shape), torch.zeros(2))
    assert recorded == [(lib, "pc_rhs_first"), (lib, "pc_rhs_tail_mid")]
    assert fr.AUX_KERNELS[lib] == ("rhs_zroll" + sfx, "rhs_zroll_upd" + sfx)
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               **dict.fromkeys(fr.AUX_KERNELS[lib], 1))
    assert fr.launch_suffix(pm) == sfx
    with pytest.raises(ValueError):
        fr.rhs_zroll(pm, torch.zeros((nf,) + shape))
    with pytest.raises(NotImplementedError):
        fr.rhs_wrap_shock(pm, torch.zeros((nf,) + shape))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_step_launches_one_k4_and_two_k5(recorded, monkeypatch,  # noqa: F811
                                         layout):
    """The zroll chain at order 3 (as the card runs it): one K4 and two K5
    of the layout's build per step; without the shock slot no substep
    runs the shock pre-pass."""
    pm = pt.Model(config(pt, layout, (16, 16, 32)), device="cpu")
    lib = LAYOUTS[layout][1]
    state = pm.init_state(0)
    monkeypatch.setattr(fr, "_nblocks", lambda shape, lib: 1)
    monkeypatch.setattr(torch, "amax", lambda t: torch.ones(()))
    passes = []
    refresh = pm._refresh_aux_fa
    monkeypatch.setattr(pm, "_refresh_aux_fa",
                        lambda *a: passes.append(1) or refresh(*a))
    pm._aux_step(state)
    assert recorded == [(lib, "pc_rhs_first")] + [
        (lib, "pc_rhs_tail_mid")] * 2
    assert len(passes) == (3 if "shock" in pm.reg.slots else 0)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_registry_layout_matches_jax(layout):
    pm = pt.Model(config(pt, layout, 8), device="cpu")
    jm = pj.Model(config(pj, layout, 8))
    names = LAYOUTS[layout][2]
    assert pm.reg.comp_names == jm.reg.comp_names == names
    assert list(pm.reg.slots) == list(jm.reg.slots)
    nvar = len(names) - ("shock" in names)
    assert (pm.reg.nvar, pm.reg.nf) == (jm.reg.nvar, jm.reg.nf) \
        == (nvar, len(names))
    assert [m.name for m in pm.modules] == [m.name for m in jm.modules]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_state_from_jax_round_trips(layout):
    """A JAX state of the layout becomes the port's, slot for slot in the
    JAX registration order, and goes back unchanged."""
    jm = pj.Model(config(pj, layout, 8))
    js = jm.init_state(2)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = state_from_numpy(fields, js["t"], js["dt"], js["it"], device="cpu")
    pm = pt.Model(config(pt, layout, 8), device="cpu")
    assert set(ps["fields"]) == set(pm.reg.slots)
    np.testing.assert_array_equal(pm.reg.stack(ps["fields"]).numpy(),
                                  np.asarray(jm.reg.stack(js["fields"])))
    back = state_to_numpy(ps)
    for k, v in fields.items():
        np.testing.assert_array_equal(back["fields"][k], v)
    s = pm.init_state(0, overrides=overrides_from_numpy(fields, pm.reg))
    for k, v in fields.items():
        np.testing.assert_array_equal(s["fields"][k].numpy(), v)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_params_of_the_layout(layout):
    """S, the del6 rate and Ω in every layout; ν_sh only with the shock
    slot, η and η₃ only with A."""
    cfg = config(pt, layout, 8)
    p = fr.kernel_params(pt.Model(cfg, device="cpu"))
    assert p.S == np.float32(-1.5) and p.dif3 > 0.0
    assert list(p.om) == [0.0, 0.0, 1.0]
    assert p.nu_shock == (1.0 if "shock" in LAYOUTS[layout][2] else 0.0)
    magnetic = LAYOUTS[layout][0].get("magnetic", True)
    assert (p.eta > 0.0, p.eta3 > 0.0) == (magnetic, magnetic)


@pytest.mark.parametrize("forced", (True, False), ids=("forced", "unforced"))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_gate_accepts_the_layout(layout, forced):
    """Each layout runs the zroll chain on the card and on the CPU, forced
    or not."""
    cfg = config(pt, layout)
    mods = tuple(m for m in cfg.modules if m.name != "forcing")
    cfg = cfg.replace(modules=mods + ((pt.Forcing(),) if forced else ()))
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    assert pt.Model(cfg, device="cpu").mode == "zroll"


def test_nu_shock_without_shock_stays_refused():
    """'nu-shock' reads the Shock module's slot: a shear box without it
    stays outside the gate, and the port refuses it on every device."""
    cfg = _with_module(config(pt, "mhd_ns"), "viscosity", pt.Viscosity(
        ivisc=("nu-const", "nu-shock"), nu=5e-4, nu_shock=1.0))
    assert "nu-shock" in gate_reason(cfg)
    with pytest.raises(NotImplementedError, match="nu-shock"):
        pt.Model(cfg, device="cpu")


@pytest.mark.parametrize("pkg", (pt, pj), ids=("port", "jax"))
def test_shear_box_defaults_to_mhd_with_shock(pkg):
    """``magnetic=True, shock=True`` are the defaults, in both packages:
    the 8-slot box of before (nu-const, nu-shock, hyper3; Magnetic;
    Shock; unforced).  ``shock=False`` drops Shock and 'nu-shock';
    ``magnetic=False`` drops Magnetic and adds non-helical forcing."""
    cfg = shear_box(16, pkg=pkg)
    assert cfg == shear_box(16, pkg=pkg, magnetic=True, shock=True)
    assert [m.name for m in cfg.modules] == [
        "eos", "density", "hydro", "shear", "viscosity", "magnetic",
        "shock"]
    visc = cfg.module("viscosity")
    assert visc.ivisc == ("nu-const", "nu-shock", "hyper3-simplified")
    assert visc.nu_shock == 1.0 and visc.nu == 5e-4
    ns = shear_box(16, pkg=pkg, shock=False)
    assert [m.name for m in ns.modules] == [
        "eos", "density", "hydro", "shear", "viscosity", "magnetic"]
    assert ns.module("viscosity").ivisc == ("nu-const", "hyper3-simplified")
    assert ns.module("viscosity").nu_hyper3 == visc.nu_hyper3
    hyd = shear_box(16, pkg=pkg, magnetic=False)
    assert [m.name for m in hyd.modules] == [
        "eos", "density", "hydro", "shear", "viscosity", "forcing",
        "shock"]
    force = hyd.module("forcing")
    assert (force.force, force.kf, force.relhel) == (0.05, 3.0, 0.0)


def test_jax_fused_shear_box_without_aux_reference_fault():
    """The reference fault that tests/test_torch_shear_layout_steps.py
    works around (``zroll_tails``): the JAX fused step of
    the hydro shear box without the shock slot builds the wrap mode's
    tail kernel for its later substeps, and one step leaves the JAX jnp
    path (which the port's zroll chain and eager path match) by far more
    than the parity bound; with the predicate answered as zroll it stays
    within it."""
    shape = (8, 8, 8)
    cfg = steps.config(pj, "hydro_ns", shape, "still")
    cfg = cfg.replace(modules=tuple(m for m in cfg.modules
                                    if m.name != "forcing"))
    out = {}
    for name in ("fault", "zroll", "jnp"):
        jm = pj.Model(cfg if name != "jnp" else cfg.replace(fused=False))
        calls = []
        if name == "zroll":
            steps.zroll_tails(jm)
        steps.spy_fused_rhs(jm, calls)
        out[name] = (jax.jit(jm.make_step())(jm.init_state(5))["fields"],
                     calls)
    assert (True, True, False) in out["fault"][1]
    assert set(out["zroll"][1]) == {(False, False, False),
                                    (True, False, False)}
    ref = out["jnp"][0]["uu"]
    err = {k: float(np.abs(np.asarray(out[k][0]["uu"] - ref)).max())
           for k in ("fault", "zroll")}
    scale = float(np.abs(np.asarray(ref)).max())
    assert err["fault"] > 100 * RTOL_FIELD * scale, err
    assert err["zroll"] <= RTOL_FIELD * scale, err
