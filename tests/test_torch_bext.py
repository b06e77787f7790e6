"""Magnetic's imposed uniform field B_ext in pencil_tpu_torch against
pencil_tpu on the CPU: B = ∇×A + B_ext and the pencils that read it (u×B,
J×B/ρ, the Alfvén speed) against the JAX Pencils; the first kernel's plain
version of each MHD chain (K1, K1e, K1s, K4, K6m, K6mi) and 3 steps of
each, through the port's eager path and through its fused chain on the
plain versions, against the JAX jnp path; the Alfvén wave on a uniform
field; the time-series columns that read B_ext.

The JAX fused step raises with B_ext ≠ 0 (ROADMAP Queue 3: the traced
kernel captures B_ext as a constant), so B_ext is held to the JAX jnp
path.  The sets: the flagship, forced_entropy, the shocked and the
sheared box (from t = 0.37), magnetoconvection and the
negative-effective-magnetic-pressure box (``strat_box(n, shear=False,
forcing=0.05, b_ext=(0, NEMPI_B0, 0))``), each at 8×8×16 with velocity and
vector-potential noise of 1e-2 from numpy with a seed (at the
configurations' 1e-3 a velocity beside the O(1) pressure and gravity
forces of the stratified sets sits near its float32 floor,
tests/test_torch_zghost.py), the forced ones kicked with the JAX step's
own draws.  Bounds, those of tests/test_fused.py: each field within 2e-5
× its max, dt and the CFL maximum within 1e-6 relative; the columns
within tests/test_torch_run.py's bounds.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.io.diagnostics import make_diagnostics as jax_diagnostics
from pencil_tpu.parallel.halo import fill_ghosts as jax_fill_ghosts
from pencil_tpu.physics.pencils import Pencils as JaxPencils
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import (NEMPI_B0, conv_slab, flagship,
                                      forced_entropy, shear_box, shock_box,
                                      strat_box)
from pencil_tpu_torch.io.diagnostics import make_diagnostics
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.physics.pencils import Pencils
from test_torch_model import jax_forcing_draws
from test_torch_run import MAXIMA
from test_torch_zghost_mhd import (AA_AMPL, RTOL_DT, UU_AMPL,
                                   assert_field_close, assert_states_close)

torch.set_num_threads(1)

NSTEPS = 3
SHAPE = (8, 8, 16)
TSTART = 0.37
# an imposed field of the size of the noise's curl A, along no axis
B_EXT = (0.03, -0.05, 0.1)


def with_b_ext(cfg, b_ext=B_EXT):
    """``cfg`` with Magnetic's B_ext set (either package)."""
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, B_ext=tuple(b_ext)) if m.name == "magnetic"
        else m for m in cfg.modules))


def _sheared(pkg, cfg):
    return cfg.replace(time=pkg.TimeSpec(itorder=3, tstart=TSTART))


# each MHD chain's set with B_ext: (make(pkg, fused), the port's mode)
SETS = {
    "flagship": (lambda pkg, fused: flagship(SHAPE, pkg=pkg, fused=fused,
                                             b_ext=B_EXT), "wrap"),
    "forced_entropy": (lambda pkg, fused: with_b_ext(forced_entropy(
        SHAPE, pkg=pkg, fused=fused)), "wrap"),
    "shock_box": (lambda pkg, fused: with_b_ext(shock_box(
        SHAPE, pkg=pkg, fused=fused)), "wrap_aux"),
    "shear_box": (lambda pkg, fused: _sheared(pkg, with_b_ext(shear_box(
        SHAPE, pkg=pkg, fused=fused))), "zroll"),
    "magnetoconvection": (lambda pkg, fused: with_b_ext(conv_slab(
        SHAPE, pkg=pkg, fused=fused, magnetic=True)), "zghost"),
    "nempi": (lambda pkg, fused: strat_box(
        SHAPE, pkg=pkg, fused=fused, shear=False, forcing=0.05,
        b_ext=(0.0, NEMPI_B0, 0.0)), "zghost"),
}


def start_fields(jm, seed):
    """The JAX init of ``jm`` (its hydrostatic lnρ and ss where it has
    them) with u and A replaced by seeded numpy noise: numpy fields."""
    rng = np.random.default_rng(seed)
    over = {"uu": (UU_AMPL * rng.standard_normal((3,) + SHAPE))
            .astype(np.float32),
            "aa": (AA_AMPL * rng.standard_normal((3,) + SHAPE))
            .astype(np.float32)}
    js = jm.init_state(seed, overrides=over)
    return js, {k: np.asarray(v) for k, v in js["fields"].items()}


@pytest.fixture(scope="module", params=sorted(SETS))
def jnp_run(request):
    """(set, the JAX jnp path's state after NSTEPS steps, its start
    fields, its forcing draws)."""
    make, _ = SETS[request.param]
    jm = pj.Model(make(pj, False))
    js, fields = start_fields(jm, 7)
    draws = (jax_forcing_draws(jm, js["key"], NSTEPS)
             if jm.cfg.module("forcing") is not None else None)
    step = jm.make_step()
    for _ in range(NSTEPS):
        js = step(js)
    return request.param, js, fields, draws


def port_run(case, fields, draws, fused):
    make, mode = SETS[case]
    pm = pt.Model(make(pt, fused), device="cpu")
    assert pm.mode == (mode if fused else None)
    ps = pm.init_state(7, overrides=overrides_from_numpy(fields, pm.reg))
    if pm.forcing is not None:
        pm.forcing_draws = iter(draws).__next__
    step = pm.make_step()
    for _ in range(NSTEPS):
        ps = step(ps)
    return ps


def evolved(state):
    """``state`` without its shock slot: the JAX jnp path keeps the slot
    at its initial zeros (as the port's eager path does), the fused chain
    holds its last pre-pass (ROADMAP Queue 3, not a fault)."""
    return dict(state, fields={k: v for k, v in state["fields"].items()
                               if k != "shock"})


def test_fused_chain_with_b_ext_matches_jax_jnp_path(jnp_run):
    """The port's fused chain on the plain versions of its kernels, 3
    steps."""
    case, js, fields, draws = jnp_run
    assert_states_close(evolved(js),
                        evolved(port_run(case, fields, draws, True)))


def test_eager_step_with_b_ext_matches_jax_jnp_path(jnp_run):
    """The port's eager path (fused=False), 3 steps."""
    case, js, fields, draws = jnp_run
    assert_states_close(evolved(js),
                        evolved(port_run(case, fields, draws, False)))


def first_plain(pm, fa, t):
    """(df, max 1/dt) of the plain version of ``pm``'s first kernel on the
    state ``fa`` at time ``t``, its input made as its chain makes it."""
    sdy = pm.deltay(torch.tensor(t, dtype=torch.float32))
    aux = pm.reg.nf > pm.reg.nvar
    if pm.mode == "wrap":
        return fr.rhs_first(pm, fa)
    if pm.mode == "wrap_aux":
        return fr.rhs_wrap_shock(pm, pm._refresh_aux_fa(fa))
    if pm.mode == "zroll":
        f = pm._refresh_aux_fa(fa, sdy) if aux else fa
        return fr.rhs_zroll(pm, pm.ghosted(f, (0, 1), sdy))
    return fr.rhs_zg(pm, *pm.zg_input(fa.clone(), sdy))


@pytest.mark.parametrize("case", sorted(SETS))
def test_first_kernel_plain_with_b_ext_matches_jax_rhs(case):
    """The first kernel's plain version of each chain with B_ext against
    the JAX jnp path's RHS on the same state (its walls pinned where it
    has them): df of every field and the CFL maximum, which holds the
    Alfvén speed of B_ext."""
    make, mode = SETS[case]
    jm = pj.Model(make(pj, False))
    pm = pt.Model(make(pt, True), device="cpu")
    _, fields = start_fields(jm, 9)
    fa = pm.bc_writeback(pm.reg.stack(pm.init_state(
        9, overrides=overrides_from_numpy(fields, pm.reg))["fields"]))
    t = jm.cfg.time.tstart
    df, dt1m = first_plain(pm, fa, t)
    jdf, jdt1, _ = jm.rhs(jnp.asarray(fa.numpy()), jm.grid, t)
    np.testing.assert_allclose(float(dt1m), float(jnp.max(jdt1)),
                               rtol=RTOL_DT)
    jdf = np.asarray(jdf)
    assert df.shape == jdf.shape
    for c in range(df.shape[0]):
        assert_field_close(df[c], jdf[c], f"{case} df[{c}]")


# ---- the pencils ---------------------------------------------------------------
@pytest.fixture(scope="module")
def pencils():
    """The JAX and the port's Pencils of the flagship with B_ext on one
    noisy ghosted state at 8×8×16."""
    jm = pj.Model(flagship(SHAPE, pkg=pj, fused=False, b_ext=B_EXT))
    pm = pt.Model(flagship(SHAPE, pkg=pt, b_ext=B_EXT), device="cpu")
    rng = np.random.default_rng(4)
    fa = (np.array([1e-2] * 3 + [5e-2] + [1e-2] * 3, np.float32)[
        :, None, None, None] * rng.standard_normal((7,) + SHAPE)).astype(
        np.float32)
    fg = jax_fill_ghosts(jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg,
                         jm.grid, jm.cfg, jm.eos)
    return (JaxPencils(fg, jm.grid, jm.reg, jm.cfg, jm.eos),
            Pencils(pm.ghosted(torch.tensor(fa)), pm.grid, pm.reg, pm.cfg,
                    pm.eos, ghosted=True))


@pytest.mark.parametrize("name", ("bb", "b2", "uxb", "jxbr", "va2"))
def test_pencil_with_b_ext_matches_jax(pencils, name):
    """B = ∇×A + B_ext (the curl first, then one add) and the pencils that
    read it, each component within 2e-5 × its max."""
    jp, pp = pencils
    want = np.asarray(getattr(jp, name)())
    got = getattr(pp, name)().numpy()
    assert got.shape == want.shape
    for c in range(want.shape[0] if want.ndim == 4 else 1):
        w, g = (want[c], got[c]) if want.ndim == 4 else (want, got)
        assert_field_close(g, w, f"{name}[{c}]")


def test_b_ext_moves_b_by_the_imposed_field(pencils):
    """The port's B with B_ext less its B without: B_ext at every point
    (within f32 rounding of the sum)."""
    _, pp = pencils
    plain = Pencils(pp.f, pp.grid, pp.reg,
                    pp.cfg.replace(modules=tuple(
                        dataclasses.replace(m, B_ext=(0.0, 0.0, 0.0))
                        if m.name == "magnetic" else m
                        for m in pp.cfg.modules)), pp.eos, ghosted=True)
    d = (pp.bb() - plain.bb()).numpy()
    for a in range(3):
        np.testing.assert_allclose(d[a], B_EXT[a], atol=1e-8)


# ---- the Alfvén wave --------------------------------------------------------------
@pytest.mark.parametrize("fused", (False, True), ids=("eager", "wrap_chain"))
def test_alfven_wave_on_a_uniform_b_ext(fused):
    """The port's counterpart of tests/test_model_smoke.py:104-127: an
    Alfvén wave on the uniform field B_ext = B0 x̂ (A = 0) has ω = vA·k;
    started as u_y = a·sin(x), after a quarter period its energy is all
    in the magnetic perturbation, so |u_y| < 0.2·a.  ``eager``: the
    JAX test's module set on the eager path; ``wrap_chain``: the flagship
    set without forcing, ν = η = 0, on the wrap chain's plain versions."""
    n, B0, dt, ampl = 32, 1.0, 1e-2, 1e-6
    mods = [pt.EosIdealGas(gamma=1.0001, cs0=1.0), pt.Density(),
            pt.Hydro(), pt.Magnetic(B_ext=(B0, 0.0, 0.0))]
    if fused:
        mods = [pt.EosIdealGas(gamma=1.0, cs0=1.0), pt.Density(),
                pt.Hydro(), pt.Viscosity(nu=0.0),
                pt.Magnetic(B_ext=(B0, 0.0, 0.0))]
    cfg = pt.Config(grid=pt.GridSpec(nx=n, ny=4, nz=4),
                    time=pt.TimeSpec(itorder=3, dt=dt), fused=True,
                    modules=tuple(mods))
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode == ("wrap" if fused else None)
    uu = torch.zeros((3, n, 4, 4))
    uu[1] = ampl * torch.sin(pm.grid.x)[:, None, None]
    state = pm.init_state(0, overrides={"uu": uu})
    nsteps = int(round(np.pi / 2 / B0 / dt))
    state = pm.make_multi_step(nsteps)(state)
    uy = state["fields"]["uu"][1]
    assert float(uy.abs().max()) < 0.2 * ampl
    # the energy went into the field: A_z of amplitude a/k, k = 1
    aa = state["fields"]["aa"]
    assert float(aa.abs().max()) > 0.5 * ampl


# ---- the columns --------------------------------------------------------------
# the columns that read B_ext, and the B columns of tests/test_torch_run.py,
# which now read B = ∇×A + B_ext
BEXT_COLUMNS = ("bbxmax", "bbymax", "bbzmax", "uxbm")
B_COLUMNS = ("brms", "bmax", "b2m", "bx2m", "by2m", "bz2m", "bm2", "abm",
             "jbm", "vA2m", "vArms", "vAmax", "bmx", "bmy", "bmz", "EEM",
             "emag")


@pytest.fixture(scope="module")
def both_rows():
    """The columns on one noisy state of forced_entropy(16) with B_ext,
    from the JAX evaluator and from the port's."""
    def cfg(pkg):
        return with_b_ext(forced_entropy(16, pkg=pkg))

    jm = pj.Model(cfg(pj))
    pm = pt.Model(cfg(pt), device="cpu")
    rng = np.random.default_rng(5)
    shape = (16, 16, 16)
    fields = {"uu": 1e-2 * rng.standard_normal((3,) + shape),
              "lnrho": 5e-2 * rng.standard_normal(shape),
              "ss": 0.1 + 1e-2 * rng.standard_normal(shape),
              "aa": 1e-2 * rng.standard_normal((3,) + shape)}
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    js = jm.init_state(2, overrides=fields)
    ps = pm.init_state(2, overrides=fields)
    names = BEXT_COLUMNS + B_COLUMNS
    want = {k: np.asarray(v) for k, v in jax_diagnostics(jm, names)(js)
            .items()}
    got = {k: v.numpy() for k, v in make_diagnostics(pm, names)(ps).items()}
    # the rms of the terms that uxbm averages, (u×B)·B_ext/B_ext²
    pen = Pencils(pm.ghosted(pm.reg.stack(ps["fields"])), pm.grid, pm.reg,
                  pm.cfg, pm.eos, ghosted=True)
    uxb = pen.uxb()
    b0 = np.asarray(B_EXT, np.float32)
    terms = sum(uxb[a] * float(b0[a]) for a in range(3)) / float(
        (b0 ** 2).sum())
    return want, got, float(torch.sqrt((terms ** 2).mean()))


@pytest.mark.parametrize("name", BEXT_COLUMNS + B_COLUMNS)
def test_column_with_b_ext_matches_jax(both_rows, name):
    """The extrema within MAXIMA's units in the last place (bb*max, B less
    B_ext, one); uxbm, the mean of zero-mean noise, within 1e-6 of its
    terms' rms; the other means within 1e-6 relative."""
    want, got, uxb_rms = both_rows
    w, g = np.float32(want[name]), np.float32(got[name])
    if name in MAXIMA or name.startswith("bb"):
        ulp = float(np.spacing(np.abs(w)))
        assert abs(float(g) - float(w)) <= MAXIMA.get(name, 1) * ulp, name
    elif name == "uxbm":
        assert abs(float(g) - float(w)) <= 1e-6 * uxb_rms, name
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0.0)
    assert w != 0.0, name


def test_bbmax_leaves_out_b_ext():
    """bbxmax … bbzmax with B_ext are those of the same state without it
    (B less B_ext, within one unit in the last place of the add and the
    subtraction), while bmax moves with B_ext."""
    rng = np.random.default_rng(6)
    fields = {"uu": 1e-2 * rng.standard_normal((3,) + SHAPE),
              "aa": 1e-2 * rng.standard_normal((3,) + SHAPE)}
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    names = ("bbxmax", "bbymax", "bbzmax", "bmax")
    rows = []
    for b_ext in (B_EXT, (0.0, 0.0, 0.0)):
        pm = pt.Model(flagship(SHAPE, b_ext=b_ext), device="cpu")
        rows.append({k: float(v) for k, v in make_diagnostics(pm, names)(
            pm.init_state(0, overrides=fields)).items()})
    for k in names[:3]:
        assert abs(rows[0][k] - rows[1][k]) <= 2 * float(
            np.spacing(np.float32(rows[1][k]))), k
    assert abs(rows[0]["bmax"] - rows[1]["bmax"]) > 1e-3
