"""The sheared, rotating MHD box in pencil_tpu_torch against pencil_tpu:
the ported pieces (der6, del6, the shear-periodic ghost fill, the shock
pre-pass and its filters), K4 and K5's plain versions against the zroll
Pallas kernels they replace, three steps of the zroll chain and of the
eager path against the JAX fused and jnp paths, and the gate.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode.  Every run starts at t = 0.37, where deltay =
0.555·Ly is not a whole number of cells (at t = 0 the shift is the
identity).  Bounds are those of tests/test_fused.py: each field within
2e-5 × its max, dt within 1e-6 relative; a Fourier-shifted ghost fill
within 1e-6 of each field's max.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.ops import smooth as j_smooth
from pencil_tpu.ops import stencil as j_stencil
from pencil_tpu.parallel.halo import fill_ghosts as j_fill_ghosts
from pencil_tpu.physics.pencils import Pencils as JPencils
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import conv_slab, shear_box
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.ops import smooth, stencil
from pencil_tpu_torch.physics.pencils import Pencils

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
RTOL_FILL = 1e-6
TSTART = 0.37
NSTEPS = 3
N = 16


def config(pkg, n=N, fused=True):
    cfg = shear_box(n, fused=fused, pkg=pkg)
    return dataclasses.replace(
        cfg, time=pkg.TimeSpec(itorder=3, tstart=TSTART))


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def noisy_fa(shape, seed):
    """An 8-slot stack (uu, lnrho, aa, shock) of numpy noise with a
    positive shock slot."""
    rng = np.random.default_rng(seed)
    amp = np.array([1e-2] * 4 + [1e-4] * 3)[:, None, None, None]
    fa = amp * rng.standard_normal((7,) + shape)
    shock = 1e-3 * rng.random((1,) + shape)
    return np.concatenate([fa, shock]).astype(np.float32)


def deltas(jm, pm, t=TSTART):
    """deltay at f32 time t in both packages."""
    gs = jm.cfg.grid
    dj = jm.cfg.module("shear").deltay(jnp.float32(t), gs.Lx, gs.Ly)
    dp = pm.deltay(torch.tensor(t, dtype=torch.float32))
    return dj, dp


def j_ghosted(jm, fa, axes, sdy):
    return np.asarray(j_fill_ghosts(
        jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg, jm.grid, jm.cfg,
        jm.eos, axes=axes, shear_dy=sdy))


@pytest.fixture(scope="module")
def models():
    return pj.Model(config(pj)), pt.Model(config(pt), device="cpu")


# ---- ported pieces --------------------------------------------------------
@pytest.mark.parametrize("wrap", (True, False), ids=("wrap", "ghosted"))
@pytest.mark.parametrize("axis", (0, 1, 2))
def test_der6_matches_jax(axis, wrap):
    rng = np.random.default_rng(axis)
    shape = (2,) + ((12, 10, 14) if wrap else (18, 16, 20))
    f = rng.standard_normal(shape).astype(np.float32)
    want = j_stencil.der6(jnp.asarray(f), axis, None, wrap=wrap)
    got = stencil.der6(torch.tensor(f), axis, wrap=wrap)
    assert_field_close(got, want, "der6", rtol=1e-6)


@pytest.mark.parametrize("mode", ("ghosted", "wrap_z"))
def test_del6_matches_jax(models, mode):
    """del6v_scaled and del6s_scaled of the Pencils, fully ghosted and in
    the zroll tiles' wrap_z mode."""
    jm, pm = models
    axes = (0, 1, 2) if mode == "ghosted" else (0, 1)
    dj, dp = deltas(jm, pm)
    fg = j_ghosted(jm, noisy_fa((N, N, N), 3), axes, dj)
    jp = JPencils(jnp.asarray(fg), jm.grid, jm.reg, jm.cfg, jm.eos,
                  wrap_z=mode == "wrap_z")
    pp = Pencils(torch.tensor(fg), pm.grid, pm.reg, pm.cfg, pm.eos,
                 ghosted=mode == "ghosted", wrap_z=mode == "wrap_z")
    assert_field_close(pp.del6v_scaled("uu"), jp.del6v_scaled("uu"), "uu")
    assert_field_close(pp.del6v_scaled("aa"), jp.del6v_scaled("aa"), "aa")
    assert_field_close(pp.del6s_scaled("lnrho"), jp.del6s_scaled("lnrho"),
                       "lnrho")
    assert_field_close(pp.grad("shock"), jp.grad("shock"), "grad shock")


def test_deltay_matches_jax(models):
    jm, pm = models
    for t in (0.0, TSTART, 1.234567, 7.5):
        dj, dp = deltas(jm, pm, t)
        assert dp.dtype == torch.float32
        assert float(dp) == float(dj), t
    assert float(deltas(jm, pm)[1]) == pytest.approx(0.555, abs=1e-6)


@pytest.mark.parametrize("axes", ((0, 1), (0, 1, 2)), ids=("xy", "xyz"))
@pytest.mark.parametrize("shape", ((16, 16, 16), (8, 32, 16)),
                         ids=("16^3", "8x32x16"))
def test_fill_ghosts_shear_matches_jax(shape, axes):
    """The shear-periodic fill: the x ghost slabs Fourier-shifted by
    ±deltay, y wrapped over the full x extent."""
    jm = pj.Model(config(pj, shape))
    pm = pt.Model(config(pt, shape), device="cpu")
    dj, dp = deltas(jm, pm)
    fa = noisy_fa(shape, 4)
    want = j_ghosted(jm, fa, axes, dj)
    got = pm.ghosted(torch.tensor(fa), axes, dp).numpy()
    unshifted = pm.ghosted(torch.tensor(fa), axes).numpy()
    for c in range(8):
        assert_field_close(got[c], want[c], f"slot {c}", rtol=RTOL_FILL)
        # the shift is not the identity at this time
        assert np.abs(unshifted[c] - want[c]).max() > 1e-3 * np.abs(
            want[c]).max()


def test_max_filter_and_smoothing_match_jax():
    rng = np.random.default_rng(7)
    f = rng.standard_normal((14, 12, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        smooth.max_filter(torch.tensor(f), 2).numpy(),
        np.asarray(j_smooth.max_filter(jnp.asarray(f), 2)))
    assert_field_close(smooth.smooth_binomial(torch.tensor(f)),
                       j_smooth.smooth_binomial(jnp.asarray(f)), "smooth",
                       rtol=1e-6)


def test_refresh_aux_shock_matches_jax(models):
    """The fused chains' pre-pass rebuilds the shock slot from u and keeps
    the evolved slots as they are."""
    jm, pm = models
    dj, dp = deltas(jm, pm)
    fa = noisy_fa((N, N, N), 5)
    want = np.asarray(jm._refresh_aux_fa(jnp.asarray(fa), jm.grid,
                                         shear_dy=dj))
    got = pm._refresh_aux_fa(torch.tensor(fa), dp).numpy()
    np.testing.assert_array_equal(got[:7], fa[:7])
    assert np.abs(want[7] - fa[7]).max() > 0.1 * np.abs(want[7]).max()
    assert_field_close(got[7], want[7], "shock")


# ---- K4 and K5 against the Pallas kernels ----------------------------------
@pytest.fixture(scope="module")
def kernels(models):
    """K4 and K5 of the JAX package (interpret mode) on x/y-ghosted
    inputs with shifted x faces, every result kept as numpy."""
    jm, pm = models
    shape = (N, N, N)
    dj, _ = deltas(jm, pm)
    assert jm._fused_mode(None, dj, N) == "zroll"
    fg = j_ghosted(jm, noisy_fa(shape, 6), (0, 1), dj)
    z = jm.grid.z
    df1, dt1 = jm._fused_rhs(shape, False, False, False)(jnp.asarray(fg), z)
    alpha, beta, _ = jm.rk
    dt = 1.0 / jnp.max(dt1)
    fg2 = j_ghosted(jm, noisy_fa(shape, 7), (0, 1), dj)
    df2, f2, _ = jm._fused_rhs(shape, True, False, False)(
        jnp.asarray(fg2), z, df1, alpha[1], beta[1] * dt)
    return dict(pm=pm, fg=fg, fg2=fg2, df1=np.asarray(df1),
                dt1max=float(jnp.max(dt1)), dt=np.float32(dt),
                df2=np.asarray(df2), f2=np.asarray(f2))


def test_rhs_zroll_matches_pallas(kernels):
    """K4's plain version: df and the max 1/dt over tiles."""
    df, dt1m = fr.rhs_zroll(kernels["pm"], torch.tensor(kernels["fg"]))
    assert dt1m.ndim == 0
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(7):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_rhs_zroll_upd_matches_pallas(kernels):
    """K5's plain version: df (written over df_prev) and f."""
    pm = kernels["pm"]
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = fr.rhs_zroll_upd(pm, torch.tensor(kernels["fg2"]), df_prev, coef)
    assert df is df_prev
    assert tuple(f.shape) == (7, N, N, N)
    for c in range(7):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


# ---- three steps against the JAX paths -------------------------------------
@pytest.fixture(scope="module")
def jax_runs():
    """The JAX fused (zroll, Pallas interpret) and jnp paths, NSTEPS steps
    each from the same initial fields; numpy results."""
    out = {}
    for fused in (True, False):
        jm = pj.Model(config(pj, fused=fused))
        js = jm.init_state(5)
        init = {k: np.asarray(v) for k, v in js["fields"].items()}
        step = jax.jit(jm.make_step())
        for _ in range(NSTEPS):
            js = step(js)
        out[fused] = dict(init=init, t=float(js["t"]), dt=float(js["dt"]),
                          it=int(js["it"]),
                          fields={k: np.asarray(v)
                                  for k, v in js["fields"].items()})
    return out


def run_port(init, fused):
    pm = pt.Model(config(pt, fused=fused), device="cpu")
    assert pm.mode == ("zroll" if fused else None)
    ps = pm.init_state(5, overrides=overrides_from_numpy(init, pm.reg))
    for k, v in init.items():
        np.testing.assert_array_equal(ps["fields"][k].numpy(), v, k)
    step = pm.make_step()
    for _ in range(NSTEPS):
        ps = step(ps)
    return ps


def assert_steps_close(ps, ref):
    np.testing.assert_allclose(float(ps["dt"]), ref["dt"], rtol=RTOL_DT)
    np.testing.assert_allclose(float(ps["t"]), ref["t"], rtol=RTOL_DT)
    assert int(ps["it"]) == ref["it"]
    for k in ("uu", "lnrho", "aa"):
        assert_field_close(ps["fields"][k], ref["fields"][k], k)


def test_zroll_step_matches_jax_fused(jax_runs):
    """The port's zroll chain (plain K4/K5 on the CPU) against the JAX
    fused zroll step; the state's shock slot is the last pre-pass's in
    both."""
    ref = jax_runs[True]
    ps = run_port(ref["init"], fused=True)
    assert_steps_close(ps, ref)
    assert np.abs(ref["fields"]["shock"]).max() > 0.0
    assert_field_close(ps["fields"]["shock"], ref["fields"]["shock"],
                       "shock")


def test_eager_step_matches_jax_jnp_path(jax_runs):
    """fused=False: the port's eager path against the JAX jnp path.  The
    jnp path writes the shock into its ghosted copy only, so the state
    keeps its initial (zero) shock slot: held with the bound as an
    absolute value."""
    ref = jax_runs[False]
    ps = run_port(ref["init"], fused=False)
    assert_steps_close(ps, ref)
    err = np.abs(ps["fields"]["shock"].numpy() - ref["fields"]["shock"])
    assert err.max() <= RTOL_FIELD


def test_packed_multi_step_bit_identical_to_dict_step():
    pm = pt.Model(shear_box(8), device="cpu")
    a = pm.init_state(3)
    for _ in range(2):
        a = pm.make_step()(a)
    b = pm.make_multi_step(2)(pm.init_state(3))
    for key in ("t", "dt", "it"):
        assert torch.equal(a[key], b[key]), key
    for k in a["fields"]:
        assert torch.equal(a["fields"][k], b["fields"][k]), k


def test_registry_layout_matches_jax():
    pm = pt.Model(shear_box(8), device="cpu")
    jm = pj.Model(shear_box(8, pkg=pj))
    assert pm.reg.comp_names == jm.reg.comp_names == [
        "ux", "uy", "uz", "lnrho", "ax", "ay", "az", "shock"]
    assert (pm.reg.nvar, pm.reg.ncom, pm.reg.nf) == (7, 8, 8)
    assert [m.name for m in pm.modules] == [m.name for m in jm.modules]


# ---- the gate ----------------------------------------------------------------
def test_gate_accepts_shear_box():
    cfg = shear_box(16)
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True


def test_gate_accepts_shear_box_without_shear():
    """Without Shear the shear box's modules, Coriolis and hyper3 included,
    run the shocked periodic box's chain (K1s/K5w)."""
    cfg = shear_box(16).replace(modules=tuple(
        m for m in shear_box(16).modules if m.name != "shear"))
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    assert pt.Model(cfg, device="cpu").mode == "wrap_aux"


def _replace_module(cfg, name, new):
    return cfg.replace(modules=tuple(new() if m.name == name else m
                                     for m in cfg.modules))


REJECTED = {
    # the highorder profile itself runs since every switch of the Shock
    # module (ACCEPTED); its max filter past the ghost width does not
    "shock_highorder": lambda: _replace_module(
        shear_box(16), "shock",
        lambda: pt.Shock(variant="highorder", ishock_max=4)),
    # SAFI and 'hyper3-mesh' run (ACCEPTED); both flavours of del6 on u,
    # or SAFI on a module set that no shear build has, do not
    "hyper3_mesh_and_simplified": lambda: _replace_module(
        shear_box(16), "viscosity",
        lambda: pt.Viscosity(ivisc=("nu-const", "hyper3-simplified",
                                    "hyper3-mesh"), nu=5e-4,
                             nu_hyper3=1e-9)),
    "safi_beside_the_walled_shock": lambda: conv_slab(
        8, shock=True, Omega=0.5).replace(modules=conv_slab(
            8, shock=True, Omega=0.5).modules + (
            pt.Shear(Omega=0.5, lshearadvection_as_shift=True),)),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_gate_rejects_on_cuda(case):
    """Outside the shear-box kernels a CUDA model raises before it
    allocates (no GPU needed); the highorder shock's max filter over more
    than the ghost width (ishock_max = 4) raises on every device, both
    flavours of del6 on one field and SAFI outside the shear sets on the
    card."""
    with pytest.raises(NotImplementedError):
        cfg = REJECTED[case]()
        assert gate_reason(cfg) is not None
        fused_gate(cfg, "cuda")


ACCEPTED = {
    # the zroll chain kicks after the step, as JAX's zroll mode does in
    # after_timestep
    "forced": (lambda: shear_box(16).replace(
        modules=shear_box(16).modules + (pt.Forcing(),)), "zroll"),
    # the flagship's module set with Coriolis: K1-K3 carry −2Ω×u
    "coriolis_without_shear": (lambda: shear_box(16).replace(modules=(
        pt.EosIdealGas(gamma=1.0), pt.Density(), pt.Hydro(Omega=1.0),
        pt.Viscosity(nu=5e-4), pt.Magnetic(eta=5e-4))), "wrap"),
    # the Shock module's 'highorder' profile: the pre-pass builds it, the
    # shear box's kernels read it as they read the 'original' one
    "shock_highorder": (lambda: _replace_module(
        shear_box(16), "shock", lambda: pt.Shock(variant="highorder")),
        "zroll"),
    # SAFI: K4/K5 with the shear flow's nodes at 0, the shift between substeps
    "safi": (lambda: _replace_module(
        shear_box(16), "shear",
        lambda: pt.Shear(lshearadvection_as_shift=True)), "zroll"),
    # 'hyper3-mesh' alone on u: K4/K5's H3 instance with the mesh weights
    "hyper3_mesh": (lambda: _replace_module(
        shear_box(16), "viscosity",
        lambda: pt.Viscosity(ivisc=("nu-const", "hyper3-mesh"), nu=5e-4)),
        "zroll"),
}


@pytest.mark.parametrize("case", sorted(ACCEPTED))
def test_gate_accepts_on_cuda(case):
    """The forced shear box, the flagship with Coriolis, the shear box
    with the 'highorder' shock profile, with SAFI and with 'hyper3-mesh'
    run a fused chain on the card and on the CPU."""
    make, mode = ACCEPTED[case]
    cfg = make()
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    assert pt.Model(cfg, device="cpu").mode == mode


def test_coriolis_stays_outside_the_zghost_chain():
    """Whether Coriolis stays outside the zghost chain: it does not. K6/K7
    have a ROT instance each, so the conv-slab with Ω runs the zghost
    chain on the card and on the CPU, with Ω about z in the kernels'
    constants."""
    from pencil_tpu_torch.configs import conv_slab
    cfg = conv_slab(8)
    cfg = cfg.replace(modules=tuple(
        pt.Hydro(init=m.init, ampl=m.ampl, Omega=1.0) if m.name == "hydro"
        else m for m in cfg.modules))
    assert cfg == conv_slab(8, Omega=1.0)
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode == "zghost"
    from pencil_tpu_torch.ops import fused_rhs as fr
    assert list(fr.kernel_params(pm).om) == [0.0, 0.0, 1.0]
    assert {"rhs_zg rot", "rhs_zg_upd rot"} <= set(
        fr.library_instances(fr.zg_library(pm)))


def test_shock_outside_a_periodic_grid_raises():
    cfg = shear_box(16)
    with pytest.raises(NotImplementedError):
        pt.Model(cfg.replace(grid=dataclasses.replace(
            cfg.grid, periodic=(True, True, False))), device="cpu")
    with pytest.raises(NotImplementedError):
        pt.Model(cfg.replace(modules=tuple(
            m for m in cfg.modules if m.name not in ("shock",))), device="cpu")
