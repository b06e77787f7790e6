"""Non-isothermal supersonic turbulence and the hydro shear box with an
entropy field in pencil_tpu_torch against pencil_tpu, kernel by kernel:
``shock_box(n, magnetic=False, entropy=True)`` (uu, lnrho, ss, shock),
``shear_box(n, magnetic=False, entropy=True)`` (the same slots) and
``shear_box(n, magnetic=False, entropy=True, shock=False)`` (uu, lnrho,
ss).  K1she/K5whe, K4he/K5he and K4hne/K5hne's plain versions against the
wrap-fetch (with the shock slot) and zroll Pallas kernels they replace,
traced for each set, at 16³ and 8×16×24; the shock heating
ν_sh·shock·(∇·u)²/T in ds and the shear's −S·x·∂s/∂y, each shown on its
own; the shifted x faces of s; the launches of each build; the registry
against JAX's and the state carried from it; the gate, the MHD layouts
with ss that the gate now admits, the layer profiles that stay refused
(each also for the MHD layouts with ss: ``shock_box(n, entropy=True)``,
``shear_box(n, entropy=True[, shock=False])``), and the builders'
defaults.  Steps are in tests/test_torch_aux_entropy_steps.py; the MHD
layouts' Pallas kernels and steps in tests/test_torch_aux_mhd_entropy.py
and tests/test_torch_aux_mhd_entropy_steps.py.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode: the shocked box on its raw periodic state, the
shear boxes on x/y-ghosted inputs at t = 0.37, where deltay = 0.555·Ly is
not a whole number of cells.  Inputs are numpy noise from a seed: u at
urms ≈ 1e-1 (shocked box) or 1e-2, lnρ and s at 1e-2, a positive shock
slot.  Bounds are those of tests/test_fused.py: each field within 2e-5 ×
its max, the CFL maximum within 1e-6 relative; the ghost fill within 1e-6
of each field's max (tests/test_torch_shear.py).
"""
import dataclasses

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
from pencil_tpu_torch.configs import shear_box, shock_box
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.ops.stencil import NGHOST
from pencil_tpu_torch.physics.pencils import Pencils
from test_torch_march_builds import _Recorder, recorded  # noqa: F401

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
RTOL_FILL = 1e-6
TSTART = 0.37
SHAPES = ((16, 16, 16), (8, 16, 24))
IDS = ("16^3", "8x16x24")
ENT = ["ux", "uy", "uz", "lnrho", "ss"]
AA = ["ax", "ay", "az"]
# each layout: its builder and keyword arguments, its build, its slots and
# the suffix of its launch names; the hydro ones, then the MHD ones
# (their Pallas kernels and steps: tests/test_torch_aux_mhd_entropy*.py)
LAYOUTS = {
    "shock": (shock_box, dict(magnetic=False, entropy=True),
              "fused_rhs_shock_hydro_ent", ENT + ["shock"], "_hydro_ent"),
    "shear": (shear_box, dict(magnetic=False, entropy=True),
              "fused_rhs_shear_hydro_ent", ENT + ["shock"], "_hydro_ent"),
    "shear_ns": (shear_box, dict(magnetic=False, entropy=True, shock=False),
                 "fused_rhs_shear_hydro_ent_ns", ENT, "_hydro_ent_ns"),
    "mhd_shock": (shock_box, dict(entropy=True), "fused_rhs_shock_ent",
                  ENT + AA + ["shock"], "_ent"),
    "mhd_shear": (shear_box, dict(entropy=True), "fused_rhs_shear_ent",
                  ENT + AA + ["shock"], "_ent"),
    "mhd_shear_ns": (shear_box, dict(entropy=True, shock=False),
                     "fused_rhs_shear_ent_ns", ENT + AA, "_ent_ns"),
}
HYDRO = ("shock", "shear", "shear_ns")


def nvar(layout):
    """The evolved fields of the layout (its slots but the shock's)."""
    return len([c for c in LAYOUTS[layout][3] if c != "shock"])


def is_shock_box(layout):
    return LAYOUTS[layout][0] is shock_box


def config(pkg, layout, shape=16, fused=True):
    make, kw = LAYOUTS[layout][:2]
    cfg = make(shape, fused=fused, pkg=pkg, **kw)
    if make is shear_box:
        cfg = dataclasses.replace(cfg, time=pkg.TimeSpec(itorder=3,
                                                          tstart=TSTART))
    return cfg


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def noisy_fa(layout, shape, seed):
    """A stack of the layout's slots of numpy noise: u at urms ≈ 1e-1 in
    the shocked box (1e-2 in the shear boxes), lnρ and s at 1e-2, a
    positive shock slot."""
    rng = np.random.default_rng(seed)
    names = LAYOUTS[layout][3]
    shocked = layout == "shock"
    amp = {"lnrho": 1e-2, "ss": 1e-2}
    uamp = 1e-1 / np.sqrt(3.0) if shocked else 1e-2
    out = [amp.get(c, uamp) * rng.standard_normal(shape) for c in names
           if c != "shock"]
    if "shock" in names:
        out.append((5e-2 if shocked else 1e-3) * rng.random(shape))
    return np.stack(out).astype(np.float32)


def deltas(jm, pm, t=TSTART):
    gs = jm.cfg.grid
    dj = jm.cfg.module("shear").deltay(jnp.float32(t), gs.Lx, gs.Ly)
    dp = pm.deltay(torch.tensor(t, dtype=torch.float32))
    return dj, dp


def j_ghosted(jm, fa, sdy, axes=(0, 1)):
    return np.asarray(j_fill_ghosts(
        jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg, jm.grid, jm.cfg,
        jm.eos, axes=axes, shear_dy=sdy))


def first_kernel(layout):
    """(the first kernel, its update kernel) of the layout's chain."""
    if is_shock_box(layout):
        return fr.rhs_wrap_shock, fr.rhs_wrap_shock_upd
    return fr.rhs_zroll, fr.rhs_zroll_upd


# ---- the first and update kernel of each layout against the Pallas ones ----
@pytest.fixture(scope="module", params=[(lay, s) for lay in HYDRO
                                        for s in SHAPES],
                ids=[f"{lay}-{i}" for lay in HYDRO for i in IDS])
def kernels(request):
    """The first and update Pallas kernels of the JAX package, traced for
    the layout (interpret mode): the wrap fetch on the raw state for the
    shocked box, the zroll fetch on x/y-ghosted inputs with shifted x faces
    for the shear boxes; numpy results."""
    layout, shape = request.param
    jm = pj.Model(config(pj, layout, shape))
    pm = pt.Model(config(pt, layout, shape), device="cpu")
    wrap = layout == "shock"
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
    """K1she, K4he or K4hne's plain version: df and the max 1/dt over
    tiles."""
    pm = kernels["pm"]
    assert fr.aux_library(pm) == LAYOUTS[kernels["layout"]][2]
    first, _ = first_kernel(kernels["layout"])
    df, dt1m = first(pm, torch.tensor(kernels["fa"]))
    assert dt1m.ndim == 0 and tuple(df.shape) == (5,) + kernels["shape"]
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(5):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_update_kernel_matches_pallas(kernels):
    """K5whe, K5he or K5hne's plain version: df (written over df_prev) and
    f."""
    pm = kernels["pm"]
    _, upd = first_kernel(kernels["layout"])
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = upd(pm, torch.tensor(kernels["fa2"]), df_prev, coef)
    assert df is df_prev
    assert tuple(f.shape) == (5,) + kernels["shape"]
    for c in range(5):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


def _with_module(cfg, name, new):
    return cfg.replace(modules=tuple(new if m.name == name else m
                                     for m in cfg.modules))


def test_shock_heating_shows_alone(kernels):
    """Where the layout has the shock slot, the slot moves ds by the shock
    heating ν_sh·shock·(∇·u)²/T (the viscous heat's second part,
    pencil_tpu/physics/viscosity.py) within the bound of ds, and by more
    than 10 times that bound; the layout without the slot has no
    ν_sh."""
    pm = kernels["pm"]
    if "shock" not in pm.reg.slots:
        assert fr.kernel_params(pm).nu_shock == 0.0
        return
    first, _ = first_kernel(kernels["layout"])
    fa = torch.tensor(kernels["fa"])
    zero = fa.clone()
    zero[5] = 0.0
    ds_full = first(pm, fa)[0][4]
    ds = ds_full - first(pm, zero)[0][4]
    # the wrap fetch reads the raw state, zroll the x/y-ghosted stack
    zroll = kernels["layout"] != "shock"
    pen = Pencils(fa, pm.grid, pm.reg, pm.cfg, pm.eos, wrap_z=zroll)
    nu_shock = pm.cfg.module("viscosity").coefficients()[1]
    shock = fa[5, NGHOST:-NGHOST, NGHOST:-NGHOST] if zroll else fa[5]
    divu = pen.divu()
    want = nu_shock * shock * divu * divu * pen.TT1()
    # within the bound of ds itself, of which the term is a part
    bound = RTOL_FIELD * float(ds_full.abs().max())
    assert float((ds - want).abs().max()) <= bound
    assert float(want.abs().max()) > 10 * bound


def _d_dy(f, dy):
    """The 6th-order ∂/∂y of a y-ghosted (mx, ny+6, nz) numpy field, in
    f64, over the interior rows."""
    w = (45.0 / 60.0, -9.0 / 60.0, 1.0 / 60.0)
    n = f.shape[1] - 2 * NGHOST
    c = NGHOST
    return sum(w[o - 1] * (f[:, c + o:c + o + n] - f[:, c - o:c - o + n])
               for o in (1, 2, 3)) / dy


def test_shear_advection_of_ss_shows_alone(kernels):
    """In the shear boxes the shear moves ds by exactly −S·x·∂s/∂y (every
    evolved field is advected by the background flow, pencil_tpu/physics/
    shear.py), against a 6th-order derivative in numpy at the kernels' x
    nodes; the shocked box has no shear."""
    pm = kernels["pm"]
    if kernels["layout"] == "shock":
        assert fr.kernel_params(pm).S == 0.0
        return
    flat = pt.Model(_with_module(pm.cfg, "shear",
                                 pt.Shear(Omega=1.0, qshear=0.0)),
                    device="cpu")
    fg = torch.tensor(kernels["fa"])
    ds = (fr.rhs_zroll(pm, fg)[0][4] - fr.rhs_zroll(flat, fg)[0][4]).numpy()
    gs = pm.cfg.grid
    S = pm.cfg.module("shear").S
    x = gs.x0 + gs.dx * (0.5 + np.arange(gs.nx))
    ss = kernels["fa"][4].astype(np.float64)[NGHOST:-NGHOST]
    want = -S * x[:, None, None] * _d_dy(ss, gs.dy)
    assert_field_close(ds, want, "shear advection of ss")
    assert np.abs(want).max() > 1e-3 * np.abs(kernels["df1"][4]).max()


# ---- the ghost fill, the builds, the layout and the state ------------------
@pytest.mark.parametrize("layout", ("shear", "shear_ns"))
def test_shifted_x_faces_carry_ss(layout):
    """The shear-periodic x/y fill of the port shifts s's x faces by
    ±deltay as JAX's does, every slot within 1e-6 of its max, and the
    shift is not the identity at t = 0.37."""
    shape = (8, 16, 24)
    jm = pj.Model(config(pj, layout, shape))
    pm = pt.Model(config(pt, layout, shape), device="cpu")
    dj, dp = deltas(jm, pm)
    fa = noisy_fa(layout, shape, 4)
    want = j_ghosted(jm, fa, dj)
    got = pm.ghosted(torch.tensor(fa), (0, 1), dp).numpy()
    unshifted = pm.ghosted(torch.tensor(fa), (0, 1)).numpy()
    assert got.shape == want.shape
    for c in range(fa.shape[0]):
        assert_field_close(got[c], want[c], f"slot {c}", rtol=RTOL_FILL)
    ss = pm.reg.slice("ss").start
    assert np.abs(unshifted[ss] - want[ss]).max() > 1e-3 * np.abs(
        want[ss]).max()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_wrappers_launch_the_layouts_build(recorded, layout):  # noqa: F811
    """The first and update wrapper launch pc_rhs_first and
    pc_rhs_tail_mid of the layout's build, counted under the launch names
    with its suffix; the other chain's wrappers are refused."""
    shape = (16, 16, 32)
    pm = pt.Model(config(pt, layout, shape), device="cpu")
    _, _, lib, names, sfx = LAYOUTS[layout]
    shocked = is_shock_box(layout)
    g2 = 0 if shocked else 2 * NGHOST
    fa = torch.zeros((len(names), shape[0] + g2, shape[1] + g2, shape[2]))
    first, upd = first_kernel(layout)
    first(pm, fa)
    upd(pm, fa, torch.zeros((nvar(layout),) + shape), torch.zeros(2))
    assert recorded == [(lib, "pc_rhs_first"), (lib, "pc_rhs_tail_mid")]
    base = (fr._WRAP_AUX if shocked else fr._ZROLL)
    assert fr.AUX_KERNELS[lib] == tuple(k + sfx for k in base)
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               **dict.fromkeys(fr.AUX_KERNELS[lib], 1))
    assert fr.launch_suffix(pm) == sfx
    other = fr.rhs_zroll if shocked else fr.rhs_wrap_shock
    with pytest.raises(NotImplementedError):
        other(pm, fa)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_step_launches_one_first_and_two_updates(recorded,  # noqa: F811
                                                 monkeypatch, layout):
    """The chain at order 3 (as the card runs it): one first and two
    update kernels of the layout's build a step; the shock pre-pass before
    each where the layout has the slot, none without it."""
    pm = pt.Model(config(pt, layout, (16, 16, 32)), device="cpu")
    lib = LAYOUTS[layout][2]
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
    names = LAYOUTS[layout][3]
    assert pm.reg.comp_names == jm.reg.comp_names == names
    assert list(pm.reg.slots) == list(jm.reg.slots)
    assert (pm.reg.nvar, pm.reg.nf) == (jm.reg.nvar, jm.reg.nf) \
        == (nvar(layout), len(names))
    assert [m.name for m in pm.modules] == [m.name for m in jm.modules]


@pytest.mark.parametrize("layout", ("shock", "shear_ns"))
def test_state_from_jax_round_trips(layout):
    """A JAX state of the 6-slot (with the shock slot) and the 5-field
    layout becomes the port's through compat.from_jax, slot for slot in
    the JAX registration order, and goes back unchanged; its fields start
    the port's state bit for bit."""
    jm = pj.Model(config(pj, layout, 8))
    rng = np.random.default_rng(3)
    over = {"ss": (1e-2 * rng.standard_normal((8, 8, 8))).astype(np.float32)}
    js = jm.init_state(2, overrides=over)
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
    assert float(np.abs(fields["ss"]).max()) > 0.0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_params_of_the_layout(layout):
    """The entropy constants (γ = 5/3, cp = 1, cp·χ, 2ν, χγ among the
    diffusivities) beside the layout's ν_sh, S, Ω and del6 rate; with A
    η, its Ohmic heat and (in the shear boxes) η₃, η among the
    diffusivities."""
    cfg = config(pt, layout, 8)
    pm = pt.Model(cfg, device="cpu")
    p = fr.kernel_params(pm)
    f32 = np.float32
    nu = cfg.module("viscosity").nu
    chi = cfg.module("entropy").chi
    mag = cfg.module("magnetic")
    eta = mag.eta if mag is not None else 0.0
    assert p.isothermal == 0 and p.gamma == f32(5.0 / 3.0) and p.cp == 1.0
    assert p.cpchi == f32(chi) and p.hcond0 == 0.0
    assert p.two_nu == f32(2.0 * nu)
    assert p.maxdif == f32(max(nu, eta, chi * 5.0 / 3.0))
    assert p.eta == p.eta_heat == f32(eta)
    assert p.eta3 == (f32(mag.eta_hyper3) if mag is not None else 0.0)
    assert p.nu_shock == (1.0 if "shock" in LAYOUTS[layout][3] else 0.0)
    shear = not is_shock_box(layout)
    assert (p.S == f32(-1.5), p.dif3 > 0.0, p.om[2] == 1.0) == (
        (True,) * 3 if shear else (False,) * 3)


# ---- the gate and the configurations ---------------------------------------
@pytest.mark.parametrize("forced", (True, False), ids=("forced", "unforced"))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_gate_accepts_the_layout(layout, forced):
    """Each layout runs its chain on the card and on the CPU, forced or
    not."""
    cfg = config(pt, layout)
    mods = tuple(m for m in cfg.modules if m.name != "forcing")
    cfg = cfg.replace(modules=mods + ((pt.Forcing(),) if forced else ()))
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    assert pt.Model(cfg, device="cpu").mode == (
        "wrap_aux" if is_shock_box(layout) else "zroll")


@pytest.mark.parametrize("make, kw, lib", (
    (shock_box, {}, "fused_rhs_shock_ent"),
    (shear_box, {}, "fused_rhs_shear_ent"),
    (shear_box, dict(shock=False), "fused_rhs_shear_ent_ns")),
    ids=("shock_box", "shear_box", "shear_box_ns"))
def test_mhd_layouts_with_ss_stay_refused(make, kw, lib):
    """``magnetic=True, entropy=True`` as the builders make it, in both
    packages: the gate admits it on the card and on the CPU, in the mode
    of its chain, and the aux builds take its layout (9 slots with the
    shock slot, 8 fields without) on a build of its own; what stays
    refused beside these layouts is Entropy's layer profiles
    (test_layer_profiles_stay_refused)."""
    cfg = make(8, entropy=True, **kw)
    assert make(8, pkg=pj, entropy=True, **kw).module("entropy") is not None
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode == ("wrap_aux" if make is shock_box else "zroll")
    assert fr.aux_library(pm) == lib
    assert pm.reg.nf == (8 if kw else 9) and pm.reg.nvar == 8


@pytest.mark.parametrize("option", (dict(cool=15.0, cs2cool=1.0),
                                    dict(luminosity=5e-3)),
                         ids=("cool", "luminosity"))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layer_profiles_stay_refused(layout, option):
    """The shock and shear builds have no terms for Entropy's cooling and
    heating layers (only the z-ghosted builds compile them): each layout
    with ss and a layer is refused on the card with the option's name,
    runs the eager path on the CPU, and the aux builds refuse it too."""
    cfg = config(pt, layout, shape=8)
    cfg = cfg.replace(modules=tuple(
        dataclasses.replace(m, **option) if m.name == "entropy" else m
        for m in cfg.modules))
    assert "Entropy.cool/luminosity" in gate_reason(cfg)
    with pytest.raises(NotImplementedError, match="cool/luminosity"):
        pt.Model(cfg, device="cuda")
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode is None
    with pytest.raises(NotImplementedError, match="cool/luminosity"):
        fr.aux_library(pm)


@pytest.mark.parametrize("pkg", (pt, pj), ids=("port", "jax"))
def test_builders_default_to_no_entropy(pkg):
    """``entropy=False`` is the default of shock_box and shear_box, in
    both packages: the isothermal configurations of before.
    ``entropy=True`` takes γ = 5/3 (cs0 = 1, cp = 1) and adds Entropy
    with 'chi-const', χ = ν (1e-3 in the shocked box, 5e-4 in the shear
    box), and nothing else."""
    for make, kws, chi in ((shock_box, ({}, dict(magnetic=False)), 1e-3),
                           (shear_box, ({}, dict(magnetic=False),
                                        dict(shock=False)), 5e-4)):
        for kw in kws:
            cfg = make(16, pkg=pkg, **kw)
            assert cfg == make(16, pkg=pkg, entropy=False, **kw)
            assert cfg.module("entropy") is None
            assert cfg.module("eos").gamma == 1.0
            ent = make(16, pkg=pkg, entropy=True, **kw)
            e = ent.module("entropy")
            assert (e.iheatcond, e.chi) == (("chi-const",), chi)
            assert chi == ent.module("viscosity").nu
            eos = ent.module("eos")
            assert (eos.gamma, eos.cs0, eos.cp) == (5.0 / 3.0, 1.0, 1.0)
            rest = [m for m in ent.modules if m.name not in ("eos",
                                                             "entropy")]
            assert rest == [m for m in cfg.modules if m.name != "eos"]
