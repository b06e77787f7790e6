"""The CUDA kernels of pencil_tpu_torch (K1-K3, K3′, K2L and K8 of the
flagship, their hydro builds K1h-K3h, K3′h, K2Lh, their entropy builds
K1e-K2Le and K1he-K2Lhe, its shock builds' K1s/K5w of the shocked periodic
box and K4/K5 of the shearing box and those of their other isothermal
layouts (K1sh/K5wh, K4n/K5n, K4h/K5h, K4hn/K5hn, each with and without Ω
and del6) and of their hydro layouts with an entropy field (K1she/K5whe,
K4he/K5he, K4hne/K5hne), K6/K7 of stratified convection, K6m/K7m
of magnetoconvection, each z-ghosted pair also with Ω, K6s/K7s and
K6ms/K7ms of the stratified shearing box, K6k/K7k and K6mk/K7mk of the
shocked conv-slab and magnetoconvection, the H3 instances
of the four periodic builds (del6 hyper-diffusion) and the CHI and H3
instances of the z-ghosted builds (chi-const, del6), every build
under gravity, and every build with the continuous forcing and, with
Magnetic, B_ext) against their plain PyTorch versions
on the card, and steps on the card against the same steps on the CPU
(forced convection and the stratified shearing box among them), and the
run loop's restart and its outputs (spectra, plane and phi averages) on
the card against the CPU.
Marked ``gpu``: they skip where there is no CUDA device.  On a machine
with one, run them with

    python -m pytest --noconftest tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py imports JAX).  This file
imports no JAX, so it also runs where JAX is not installed.
Bounds: each field within 2e-5 × its max, the CFL maximum within 1e-6
relative (the bounds of tests/test_fused.py:75-84).
"""

import dataclasses

import pytest
import torch

import pencil_tpu_torch as pt
from pencil_tpu_torch.configs import (conv_slab, forced_entropy,
                                     forced_hydro, shear_box, shock_box,
                                     strat_box, with_shock_diffusion,
                                     with_upwind)
from pencil_tpu_torch.ops import fused_rhs as fr

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def flagship(shape, itorder=3, dt=0.0):
    return pt.Config(
        grid=pt.GridSpec(nx=shape[0], ny=shape[1], nz=shape[2]),
        time=pt.TimeSpec(itorder=itorder, dt=dt), fused=True,
        modules=(pt.EosIdealGas(gamma=1.0, cs0=1.0), pt.Density(),
                 pt.Hydro(init="gaussian-noise", ampl=1e-3),
                 pt.Viscosity(nu=5e-3),
                 pt.Magnetic(init="gaussian-noise", ampl=1e-4, eta=5e-3),
                 pt.Forcing(force=0.07, kf=3.0)))


def random_fa(shape, device, seed=4, nvar=7):
    g = torch.Generator(device).manual_seed(seed)
    amp = torch.tensor([1e-2] * 3 + [5e-2] + [1e-2] * (nvar - 4),
                       device=device)
    return amp[:, None, None, None] * torch.randn(
        (nvar,) + shape, generator=g, device=device)


def assert_field_close(a, b, what):
    for c in range(a.shape[0]):
        err = float((a[c] - b[c]).abs().max())
        assert err <= RTOL_FIELD * max(float(b[c].abs().max()), 1e-30), \
            (what, c, err)


# the flagship kernels' shapes: the last breaks every edge of their x-march
# (nx below the segment MX = 64, ny not a multiple of TY = 8, nz neither a
# multiple of TZ = 32 nor of 4, so every row goes in 4-byte copies)
FLAGSHIP_SHAPES = ((32, 32, 32), (16, 24, 40), (24, 20, 42))
FLAGSHIP_IDS = ("32^3", "16x24x40", "24x20x42")


@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_kernels_match_plain(cuda, shape):
    """The second and third shapes are not multiples of the tile: ragged
    edges."""
    pm = pt.Model(flagship(shape), device=cuda)
    fa = random_fa(shape, cuda)
    fr.reset_launches()
    df1, dt1m = fr.rhs_first(pm, fa)
    df1_p, dt1m_p = fr.rhs_first_plain(pm, fa)
    torch.testing.assert_close(dt1m, dt1m_p, rtol=RTOL_DT, atol=0.0)
    alpha, beta, _ = pm.rk
    dt = 1.0 / dt1m_p
    c2 = torch.stack((pm._alpha[1], beta[1] * dt, beta[0] * dt))
    c3 = torch.stack((pm._alpha[2], beta[2] * dt, pm._zero))
    got = {"df1": df1}
    want = {"df1": df1_p}
    got["df2"], got["f2"] = fr.rhs_tail_defer(pm, fa, df1_p, c2)
    want["df2"], want["f2"] = fr.rhs_tail_defer_plain(pm, fa, df1_p, c2)
    kick = pm.forcing.kick_vector(pm._ftables, pm._draws(), dt, pm.eos)
    for name, k in (("f3", None), ("f3kick", kick)):
        got[name] = fr.rhs_tail_last(pm, want["f2"], want["df2"], c3, k)
        want[name] = fr.rhs_tail_last_plain(pm, want["f2"], want["df2"], c3, k)
    torch.cuda.synchronize()
    for name in got:
        assert_field_close(got[name], want[name], name)
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0), rhs_first=1,
                               rhs_tail_defer=1, rhs_tail_last=2)


@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_tail_and_fake_kernels_match_plain(cuda, shape):
    """K3′, K2L (with and without the kick) and K8's three variants
    against their plain versions."""
    pm = pt.Model(flagship(shape), device=cuda)
    fa, df1 = random_fa(shape, cuda), random_fa(shape, cuda, seed=5)
    alpha, beta, _ = pm.rk
    coef = torch.stack((pm._alpha[2], beta[2] * 1e-2 + pm._zero,
                        beta[1] * 1e-2 + pm._zero))
    kick = pm.forcing.kick_vector(pm._ftables, pm._draws(),
                                  pm._zero + 1e-2, pm.eos)
    fr.reset_launches()
    got, want = {}, {}
    got["mid"] = fr.rhs_tail_mid(pm, fa, df1.clone(), coef)
    want["mid"] = fr.rhs_tail_mid_plain(pm, fa, df1.clone(), coef)
    for name, k in (("defer_last", None), ("defer_last_kick", kick)):
        got[name] = fr.rhs_tail_defer_last(pm, fa, df1, coef, k)
        want[name] = fr.rhs_tail_defer_last_plain(pm, fa, df1, coef, k)
    got["first_fake"] = fr.rhs_first(pm, fa, fake=True)
    want["first_fake"] = fr.rhs_first_plain(pm, fa, fake=True)
    got["defer_fake"] = fr.rhs_tail_defer(pm, fa, df1, coef, fake=True)
    want["defer_fake"] = fr.rhs_tail_defer_plain(pm, fa, df1, coef,
                                                 fake=True)
    got["last_fake"] = fr.rhs_tail_last(pm, fa, df1, coef, kick, fake=True)
    want["last_fake"] = fr.rhs_tail_last_plain(pm, fa, df1, coef, kick,
                                               fake=True)
    torch.cuda.synchronize()
    for name in got:
        a = got[name] if isinstance(got[name], tuple) else (got[name],)
        b = want[name] if isinstance(want[name], tuple) else (want[name],)
        for x, y in zip(a, b):
            if x.ndim == 0:
                assert float(x) == float(y) == 0.0, name   # K8's CFL max
            else:
                assert_field_close(x, y, name)
    assert fr.LAUNCHES == dict(
        dict.fromkeys(fr.LAUNCHES, 0), rhs_tail_mid=1, rhs_tail_defer_last=2,
        rhs_first_fake=1, rhs_tail_defer_fake=1, rhs_tail_last_fake=1)


@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_fake_kernels_bit_exact(cuda, shape):
    """K8's K1 and K2 variants equal their plain versions bit for bit:
    their arithmetic is one rounding per operation in both, so any
    difference is a value the loader put in the wrong place."""
    pm = pt.Model(flagship(shape), device=cuda)
    fa, df1 = random_fa(shape, cuda), random_fa(shape, cuda, seed=5)
    coef = torch.stack((pm._alpha[1], pm.rk[1][1] * 1e-2 + pm._zero,
                        pm.rk[1][0] * 1e-2 + pm._zero))
    df, dt1m = fr.rhs_first(pm, fa, fake=True)
    assert torch.equal(df, fr.rhs_first_plain(pm, fa, fake=True)[0])
    assert float(dt1m) == 0.0
    for got, want in zip(fr.rhs_tail_defer(pm, fa, df1, coef, fake=True),
                         fr.rhs_tail_defer_plain(pm, fa, df1, coef,
                                                 fake=True)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("lib", ("fused_rhs", "fused_rhs_shock",
                                 "fused_rhs_shear", "fused_rhs_zg",
                                 "fused_rhs_zg_mag", "fused_rhs_zg_shear",
                                 "fused_rhs_zg_mag_shear"))
def test_dt1_buffer_matches_the_grid(cuda, lib):
    """K1 (K1s, K4) writes one CFL maximum per block of its launch grid,
    which its library's pc_tile_shape (MX, TY, TZ) sizes: at nx = 80 (two
    x segments, the second 16 planes), every slot is written and nothing
    past them."""
    import ctypes
    import math
    from pencil_tpu_torch.ops import _build
    shape = (80, 16, 32)
    if lib == "fused_rhs":
        pm = pt.Model(flagship(shape), device=cuda)
        fa = random_fa(shape, cuda)
        plain = fr.rhs_first_plain
    elif lib == "fused_rhs_shock":
        pm = pt.Model(shock_box(shape), device=cuda)
        fa = shocked_fa(pm)
        plain = fr.rhs_wrap_shock_plain
    elif lib in fr.ZG_KERNELS:
        pm = pt.Model(conv_slab(shape, magnetic="_mag" in lib, **(
            dict(Omega=1.0, shear=True) if "shear" in lib else {})),
            device=cuda)
        fa, zlo, zhi = stratified_fg(pm)
        # the slabs, the layer profiles, no K(z) ('K-profile' off), g_z
        prof_c, prof_h, grav = (t.data_ptr() for t in fr.zg_profiles(pm))
        after = (zlo.data_ptr(), zhi.data_ptr(), prof_c, prof_h, None, grav)

        def plain(pm, fa):
            return fr.zg_plain(pm)[0](pm, fa, zlo, zhi)
    else:
        pm = pt.Model(shear_box(shape), device=cuda)
        fa = sheared_fg(pm)
        plain = fr.rhs_zroll_plain
    tile = (ctypes.c_int * 3)()
    _build.load(lib).pc_tile_shape(ctypes.addressof(tile))
    n = fr._nblocks(shape, lib)
    assert n == math.prod(-(-s // t) for s, t in zip(shape, tile))
    assert shape[0] % tile[0] != 0
    blk = torch.full((n + 1,), float("nan"), device=cuda)
    df = fa.new_empty((pm.reg.nvar,) + shape)
    p = fr.kernel_params(pm)
    stream = torch.cuda.current_stream().cuda_stream
    assert _build.load(lib).pc_rhs_first(
        ctypes.addressof(p), fa.data_ptr(), df.data_ptr(), blk.data_ptr(),
        stream, *(after if lib in fr.ZG_KERNELS else (None,)),
        None) == 0
    torch.cuda.synchronize()
    assert bool(torch.isfinite(blk[:n]).all()) and bool((blk[:n] > 0).all())
    assert math.isnan(float(blk[n]))
    torch.testing.assert_close(blk[:n].max(), plain(pm, fa)[1],
                               rtol=RTOL_DT, atol=0.0)


def _steps_match(cuda, cfg, t0=None, nsteps=3, uu_noise=0.0):
    """nsteps on the card against the same steps on the CPU from the same
    fields and forcing draws; ``uu_noise`` > 0 replaces the initial
    velocity with noise of that amplitude."""
    fields = dict(pt.Model(cfg, device="cpu").init_state(5)["fields"])
    g = torch.Generator().manual_seed(9)
    if uu_noise:
        fields["uu"] = uu_noise * torch.randn(fields["uu"].shape,
                                              generator=g)
    draws = [(torch.randint(0, 20, (1,), generator=g),
              torch.rand((), generator=g) * 6.0 - 3.0,
              torch.randn(3, generator=g)) for _ in range(nsteps)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = pt.Model(cfg, device=dev)
        it = iter([tuple(t.to(dev) for t in d) for d in draws])
        model.forcing_draws = it.__next__
        s = model.init_state(5, overrides=fields)
        if t0 is not None:
            s["t"] = torch.full((), t0, device=dev)
        for _ in range(nsteps):
            s = model.make_step()(s)
        out[dev.type] = s
    assert out["cuda"]["fields"].keys() == out["cpu"]["fields"].keys()
    torch.testing.assert_close(out["cuda"]["dt"].cpu(), out["cpu"]["dt"],
                               rtol=RTOL_DT, atol=0.0)
    for k, ref in out["cpu"]["fields"].items():
        a = out["cuda"]["fields"][k].cpu()
        assert_field_close(a[None] if a.ndim == 3 else a,
                           ref[None] if ref.ndim == 3 else ref, k)


@pytest.mark.parametrize("itorder", (1, 2, 3, 4),
                         ids=("rk1", "rk2", "rk3", "rk4"))
def test_step_on_card_matches_cpu(cuda, itorder):
    """Three full steps through the kernels at each 2N-RK order against
    the same steps on the CPU (plain versions), same fields and the same
    forcing draws."""
    _steps_match(cuda, flagship((16, 16, 32), itorder))


def with_omega(cfg, omega):
    return cfg.replace(modules=tuple(
        pt.Hydro(init=m.init, ampl=m.ampl, Omega=omega) if m.name == "hydro"
        else m for m in cfg.modules))


def with_entropy(cfg, **kw):
    return cfg.replace(modules=tuple(
        pt.Entropy(**kw) if m.name == "entropy" else m for m in cfg.modules))


K_AND_CHI = dict(iheatcond=("chi-const", "K-const"), chi=5e-3, hcond0=4e-3)
# case -> (configuration, bound on each field's error over its max): the
# entropy builds sum more terms into ss and u than the others
TEMPLATE_CASES = {
    "hydro": (lambda shape: forced_hydro(shape), 1e-6),
    "hydro_omega": (lambda shape: forced_hydro(shape, Omega=1.0), 1e-6),
    "flagship_omega": (lambda shape: with_omega(flagship(shape), 1.0), 1e-6),
    "ent_mhd": (lambda shape: forced_entropy(shape), RTOL_FIELD),
    "ent_hydro": (lambda shape: forced_entropy(shape, magnetic=False),
                  RTOL_FIELD),
    "ent_mhd_K_omega": (lambda shape: with_entropy(
        forced_entropy(shape, Omega=1.0), **K_AND_CHI), RTOL_FIELD),
    "ent_hydro_K_omega": (lambda shape: with_entropy(
        forced_entropy(shape, magnetic=False, Omega=1.0),
        iheatcond=("K-const",), hcond0=4e-3), RTOL_FIELD),
}


@pytest.mark.parametrize("shape", ((32, 32, 32), (24, 20, 42)),
                         ids=("32^3", "24x20x42"))
@pytest.mark.parametrize("case", sorted(TEMPLATE_CASES))
def test_template_instances_match_plain(cuda, case, shape):
    """The hydro build's five instances (K1h, K2h, K3h, K3′h, K2Lh), the
    MHD ones with Coriolis, and the entropy builds' (K1e-K2Le, K1he-K2Lhe;
    with K-const conduction and Coriolis too) against their plain
    versions: each field within the case's bound × its max, the CFL
    maximum within 1e-6 relative."""
    make_cfg, rtol = TEMPLATE_CASES[case]
    _template_instances_match_plain(cuda, make_cfg(shape), rtol)


def _template_instances_match_plain(cuda, cfg, rtol):
    """K1, K2, K3 and K2L with and without the kick, and K3′ of ``cfg``'s
    build against their plain versions on one noisy input."""
    pm = pt.Model(cfg, device=cuda)
    shape = cfg.grid.shape
    sfx = fr.launch_suffix(pm)
    fa = random_fa(shape, cuda, nvar=pm.reg.nvar)
    alpha, beta, _ = pm.rk
    fr.reset_launches()
    df1, dt1m = fr.rhs_first(pm, fa)
    df1_p, dt1m_p = fr.rhs_first_plain(pm, fa)
    torch.testing.assert_close(dt1m, dt1m_p, rtol=RTOL_DT, atol=0.0)
    dt = 1.0 / dt1m_p
    c2 = torch.stack((pm._alpha[1], beta[1] * dt, beta[0] * dt))
    c3 = torch.stack((pm._alpha[2], beta[2] * dt, beta[1] * dt))
    kick = pm.forcing.kick_vector(pm._ftables, pm._draws(), dt, pm.eos)
    df2_p, f2_p = fr.rhs_tail_defer_plain(pm, fa, df1_p, c2)
    got = {"df1": df1}
    want = {"df1": df1_p}
    got["df2"], got["f2"] = fr.rhs_tail_defer(pm, fa, df1_p, c2)
    want["df2"], want["f2"] = df2_p, f2_p
    for name, k in (("f3", None), ("f3kick", kick)):
        got[name] = fr.rhs_tail_last(pm, f2_p, df2_p, c3, k)
        want[name] = fr.rhs_tail_last_plain(pm, f2_p, df2_p, c3, k)
        got["L" + name] = fr.rhs_tail_defer_last(pm, fa, df1_p, c3, k)
        want["L" + name] = fr.rhs_tail_defer_last_plain(pm, fa, df1_p, c3,
                                                        k)
    got["mid_df"], got["mid_f"] = fr.rhs_tail_mid(pm, f2_p, df2_p.clone(), c3)
    want["mid_df"], want["mid_f"] = fr.rhs_tail_mid_plain(
        pm, f2_p, df2_p.clone(), c3)
    torch.cuda.synchronize()
    for name in got:
        for c in range(pm.reg.nvar):
            err = float((got[name][c] - want[name][c]).abs().max())
            assert err <= rtol * max(float(want[name][c].abs().max()),
                                     1e-30), (name, c, err)
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0), **{
        "rhs_first" + sfx: 1, "rhs_tail_defer" + sfx: 1,
        "rhs_tail_last" + sfx: 2, "rhs_tail_defer_last" + sfx: 2,
        "rhs_tail_mid" + sfx: 1})



# nx over one x segment (MX = 64) with a short second one, ny not a multiple
# of the column's 8 rows, nz odd: every row goes in 4-byte copies, and the
# last blocks in y and z hold points outside the grid, which must compute
# along (the barriers are the block's) and store nothing
RAGGED_SHAPE = (70, 13, 45)
BUILDS = {
    "mhd": (lambda shape: flagship(shape), 1e-6),
    "hydro": TEMPLATE_CASES["hydro"],
    "ent_mhd": TEMPLATE_CASES["ent_mhd"],
    "ent_hydro": TEMPLATE_CASES["ent_hydro"],
    # the shock builds: K1s/K5w within 1e-6, K4/K5 (del6 of 7 fields and
    # the shifted faces) within 2e-5, chip_smoke.py's bounds
    "shock": (lambda shape: shock_box(shape), 1e-6),
    "shear": (lambda shape: shear_box(shape), RTOL_FIELD),
    # their other isothermal layouts: K1sh/K5wh within K1s/K5w's bound,
    # K4n/K5n, K4h/K5h and K4hn/K5hn within K4/K5's
    "shock_hydro": (lambda shape: shock_box(shape, magnetic=False), 1e-6),
    "shear_ns": (lambda shape: shear_box(shape, shock=False), RTOL_FIELD),
    "shear_hydro": (lambda shape: shear_box(shape, magnetic=False),
                    RTOL_FIELD),
    "shear_hydro_ns": (lambda shape: shear_box(shape, magnetic=False,
                                               shock=False), RTOL_FIELD),
    # their hydro layouts with an entropy field, within their parents'
    # bounds (chip_smoke.py's AUX_RTOL)
    "shock_hydro_ent": (lambda shape: shock_box(shape, magnetic=False,
                                                entropy=True), 1e-6),
    "shear_hydro_ent": (lambda shape: shear_box(shape, magnetic=False,
                                                entropy=True), RTOL_FIELD),
    "shear_hydro_ent_ns": (lambda shape: shear_box(
        shape, magnetic=False, entropy=True, shock=False), RTOL_FIELD),
    # and their MHD layouts with an entropy field (9 slots, or 8 fields)
    "shock_ent": (lambda shape: shock_box(shape, entropy=True), 1e-6),
    "shear_ent": (lambda shape: shear_box(shape, entropy=True), RTOL_FIELD),
    "shear_ent_ns": (lambda shape: shear_box(shape, entropy=True,
                                             shock=False), RTOL_FIELD),
}
AUX_BUILDS = ("shock", "shear", "shock_hydro", "shear_ns", "shear_hydro",
              "shear_hydro_ns", "shock_hydro_ent", "shear_hydro_ent",
              "shear_hydro_ent_ns", "shock_ent", "shear_ent",
              "shear_ent_ns")
MHD_ENT = ("shock_ent", "shear_ent", "shear_ent_ns")
NEW_AUX = AUX_BUILDS[2:]


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_all_builds_match_plain_at_a_ragged_shape(cuda, build):
    """K1, K2, K3, K3′ and K2L of the four flagship builds of the template,
    and K1s/K5w and K4/K5 of its two shock builds, at a shape that leaves
    part of a block idle in y and in z."""
    make_cfg, rtol = BUILDS[build]
    if build in AUX_BUILDS:
        _aux_kernels_match_plain(cuda, make_cfg(RAGGED_SHAPE), rtol)
    else:
        _template_instances_match_plain(cuda, make_cfg(RAGGED_SHAPE), rtol)


@pytest.mark.parametrize("shape", ((32, 32, 32), RAGGED_SHAPE),
                         ids=("32^3", "70x13x45"))
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_constant_fields_give_exactly_zero_tendencies(cuda, build, shape):
    """Every term of these module sets is a derivative or multiplies one,
    and the stencil sums form their differences first: on fields that are
    constant in space K1's df is exactly zero, and the tails reduce to
    their updates, bit for bit.  (With the FMA sums too.)  The shear
    build takes u = 0 and A_y = 0, where its Coriolis and shear terms
    vanish, on a constant x/y-ghosted stack."""
    if build in AUX_BUILDS:
        _aux_constant_fields(cuda, BUILDS[build][0](shape))
        return
    pm = pt.Model(BUILDS[build][0](shape), device=cuda)
    nvar = pm.reg.nvar
    vals = torch.tensor([0.3, -0.2, 0.1, 0.05, 0.02, 0.01, -0.02, 0.03],
                        device=cuda)[:nvar]
    fa = vals[:, None, None, None].expand((nvar,) + shape).contiguous()
    df1 = (0.5 * vals.flip(0))[:, None, None, None].expand(
        (nvar,) + shape).contiguous()
    df, dt1m = fr.rhs_first(pm, fa)
    assert not df.any()
    torch.testing.assert_close(dt1m, fr.rhs_first_plain(pm, fa)[1],
                               rtol=RTOL_DT, atol=0.0)
    coef = torch.tensor([-0.6, 3e-2, 1e-2], device=cuda)
    alpha, bdt, cprev = coef
    df2, f2 = fr.rhs_tail_defer(pm, fa, df1, coef)
    f1 = fa + cprev * df1
    assert torch.equal(df2, alpha * df1)
    assert torch.equal(f2, f1 + bdt * (alpha * df1))
    assert torch.equal(fr.rhs_tail_defer_last(pm, fa, df1, coef, None),
                       f1 + bdt * (alpha * df1))
    assert torch.equal(fr.rhs_tail_last(pm, fa, df1, coef, None),
                       fa + bdt * (alpha * df1))
    dfm, fm = fr.rhs_tail_mid(pm, fa, df1.clone(), coef)
    assert torch.equal(dfm, alpha * df1)
    assert torch.equal(fm, fa + bdt * (alpha * df1))


# the constant value of each slot in the constant-field tests of the aux
# builds
CONSTANTS = {"ux": 0.3, "uy": -0.2, "uz": 0.1, "lnrho": 0.05, "ss": 0.04,
             "ax": 0.02, "ay": 0.01, "az": -0.02, "shock": 0.03}


def _aux_constant_fields(cuda, cfg):
    """K1s/K5w or K4/K5 (of the layout's build) on constant fields, with a
    positive shock slot where the layout has one."""
    pm = pt.Model(cfg, device=cuda)
    shear = pm.mode == "zroll"
    shape = cfg.grid.shape
    names = pm.reg.comp_names
    nf, nvar = pm.reg.nf, pm.reg.nvar
    vals = torch.tensor([CONSTANTS[c] for c in names], device=cuda)
    if shear:
        vals[[k for k, c in enumerate(names)
              if c in ("ux", "uy", "uz", "ay")]] = 0.0
        first, upd = fr.rhs_zroll, fr.rhs_zroll_upd
        g = (3, 3)
    else:
        first, upd = fr.rhs_wrap_shock, fr.rhs_wrap_shock_upd
        g = (0, 0)
    fa = vals[:, None, None, None].expand(
        (nf, shape[0] + 2 * g[0], shape[1] + 2 * g[1], shape[2])).contiguous()
    df1 = (0.5 * vals[:nvar].flip(0))[:, None, None, None].expand(
        (nvar,) + shape).contiguous()
    df, dt1m = first(pm, fa)
    assert not df.any()
    plain = fr.rhs_zroll_plain if shear else fr.rhs_wrap_shock_plain
    torch.testing.assert_close(dt1m, plain(pm, fa)[1], rtol=RTOL_DT,
                               atol=0.0)
    coef = torch.tensor([-0.6, 3e-2], device=cuda)
    alpha, bdt = coef
    dfm, fm = upd(pm, fa, df1.clone(), coef)
    assert torch.equal(dfm, alpha * df1)
    f0 = vals[:nvar, None, None, None].expand((nvar,) + shape)
    assert torch.equal(fm, f0 + bdt * (alpha * df1))


@pytest.mark.parametrize("itorder", (1, 2, 3, 4),
                         ids=("rk1", "rk2", "rk3", "rk4"))
def test_forced_hydro_steps_on_card_match_cpu(cuda, itorder):
    """Three forced-hydro steps through K1h-K3h (K1h, the axpy and the kick
    after the step at order 1, K2Lh at order 2, K3′h at order 4) against
    the plain versions on the CPU."""
    cfg = forced_hydro((16, 16, 32))
    _steps_match(cuda, cfg.replace(time=pt.TimeSpec(itorder=itorder)))


@pytest.mark.parametrize("itorder", (1, 2, 3, 4),
                         ids=("rk1", "rk2", "rk3", "rk4"))
@pytest.mark.parametrize("magnetic", (True, False), ids=("mhd", "hydro"))
def test_forced_entropy_steps_on_card_match_cpu(cuda, magnetic, itorder):
    """Three steps of non-isothermal forced turbulence through the entropy
    builds at each 2N-RK order against the plain versions on the CPU."""
    cfg = forced_entropy((16, 16, 32), magnetic=magnetic)
    _steps_match(cuda, cfg.replace(time=pt.TimeSpec(itorder=itorder)))


def test_run_restart_on_card_is_bit_exact(cuda, tmp_path):
    """simulate on the card: 8 forced steps in one go against 4, a
    checkpoint, and 4 more from var.npz in a new model: the same fields
    bit for bit; the rows and COMPLETED are there."""
    from pencil_tpu_torch.io.timeseries import read_time_series
    from pencil_tpu_torch.run import RunParams, simulate
    cfg = forced_entropy(32)
    params = RunParams(it1=4, isave=4, print_columns=(
        "it", "t", "dt", "urms", "ssm", "brms", "jmax"))
    whole = simulate(cfg, nt=8, datadir=tmp_path / "a", params=params,
                     quiet=True, seed=2)
    assert whole["fields"]["uu"].is_cuda
    simulate(cfg, nt=4, datadir=tmp_path / "b", params=params, quiet=True,
             seed=2)
    again = simulate(cfg, nt=4, datadir=tmp_path / "b", params=params,
                     quiet=True, resume=True)
    assert int(again["it"]) == 8
    for k, v in whole["fields"].items():
        assert torch.equal(again["fields"][k], v), k
    assert torch.equal(again["t"], whole["t"])
    rows = read_time_series(tmp_path / "a" / "time_series.dat")
    assert rows["it"] == [0, 1, 4, 8]
    assert all(torch.isfinite(torch.tensor(v)).all() for v in rows.values())
    assert (tmp_path / "a" / "COMPLETED").exists()


def test_outputs_on_card_match_cpu(cuda):
    """The spectra, plane averages and phi averages of one state on the
    card against the same calls on the CPU: each within 2e-5 of its max
    (the spectra of the card's cuFFT, the sums of its histogram)."""
    from pencil_tpu_torch.io import averages, spectra
    cfg = forced_entropy((16, 24, 20))
    names = [f"{q}mz" for q in averages.QUANTS] + [
        "uxmy", "bymx", "rhomxy", "uzmxz", "bzmyz"]
    # one state for both: the card's generator draws other numbers
    fields = {k: v.numpy() for k, v in pt.Model(cfg, device="cpu")
              .init_state(3)["fields"].items()}
    out = {}
    for device in ("cuda", "cpu"):
        pm = pt.Model(cfg, device=device)
        state = pm.init_state(3, overrides=fields)
        pen = averages.ghosted_pencils(pm, state)
        res = {f"spec {k}": spectra.shell_spectrum(v) for k, v in
               (("kin", state["fields"]["uu"]), ("mag", pen.bb()))}
        res["spec xy"] = spectra.spectrum_xy(state["fields"]["uu"])
        res["spec 1d"] = spectra.spectrum_1d(state["fields"]["uu"], 1)
        e, h = spectra.helicity_spectrum(pen.uu(), pen.oo())
        res.update({"spec hel e": e, "spec hel h": h})
        res.update(averages.make_averages(pm, names)(pm.pack_state(state)))
        res["phi"] = averages.make_phi_averages(
            pm, ("uzmphi", "bzmphi"))[0](state)
        if device == "cuda":
            assert all(v.is_cuda for v in res.values())
        out[device] = {k: v.cpu() for k, v in res.items()}
        scale = {q: float(fn(pen).abs().max())
                 for q, fn in averages.QUANTS.items()}
    for k, want in out["cpu"].items():
        got = out["cuda"][k]
        assert got.shape == want.shape and got.dtype == torch.float32, k
        ref = (scale[averages.parse_aver_name(k)[0]]
               if k in names else float(want.abs().max()))
        assert float((got - want).abs().max()) <= RTOL_FIELD * ref, k


def test_forced_shear_box_steps_on_card_match_cpu(cuda):
    """Three forced zroll steps (K4/K5, the kick after the step) from
    t = 0.37 against the CPU."""
    cfg = shear_box((16, 16, 32))
    _steps_match(cuda, cfg.replace(modules=cfg.modules + (
        pt.Forcing(force=0.07, kf=3.0),)), t0=0.37)


def stratified_fg(pm, seed=4):
    """A conv-slab state on the card, the piecew-poly profiles with noise,
    with Magnetic a noisy vector potential, as the z-ghosted kernels take
    it (``Model.zg_input``): (fa, zlo, zhi), fa's boundary planes pinned,
    the slabs from the z-only fill; with Shear fa ghosted in x and y with
    the x faces shifted by deltay at t = 0.37, and its slabs; with the
    shock slot a positive profile of 1e-3 last."""
    g = torch.Generator(pm.device).manual_seed(seed)
    f = pm.init_state(0)["fields"]
    shape = pm.cfg.grid.shape

    def noise(sh):
        return 1e-2 * torch.randn(sh, generator=g, device=pm.device)

    parts = [noise((3,) + shape), (f["lnrho"] + noise(shape))[None],
             (f["ss"] + noise(shape))[None]]
    if "aa" in pm.reg.slots:
        parts.append(noise((3,) + shape))
    if "shock" in pm.reg.slots:
        parts.append(1e-3 * torch.rand((1,) + shape, generator=g,
                                       device=pm.device))
    sdy = (pm.deltay(torch.tensor(0.37, device=pm.device))
           if pm.shear is not None else None)
    return pm.zg_input(torch.cat(parts).contiguous(), sdy)


# the conv-slab's module sets: conv_slab keyword arguments; K6/K7, their
# Coriolis instances, K6m/K7m and theirs, K6s/K7s and K6ms/K7ms (the
# stratified shearing box), and forced convection (the kernels of the
# unforced set, the kick after the step), also sheared
ZG_CASES = {"conv_slab": {}, "rot": dict(Omega=1.0),
            "mag": dict(magnetic=True), "mag_rot": dict(magnetic=True,
                                                        Omega=1.0),
            "shear": dict(Omega=1.0, shear=True),
            "mag_shear": dict(magnetic=True, Omega=1.0, shear=True),
            "forced": dict(forcing=0.05),
            "forced_mag_shear": dict(magnetic=True, Omega=1.0, shear=True,
                                     forcing=0.05)}


# the z-ghosted builds' shapes: the flagship template's (FLAGSHIP_SHAPES);
# at 24x20x42 no row goes in 16-byte copies and the last column of z
# blocks hangs over the end of z
@pytest.mark.parametrize("case", ZG_CASES)
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_zghost_kernels_match_plain(cuda, shape, case):
    """K6 and K7 (the z-ghosted build of the flagship template), K6m and
    K7m (its 8-field build), each without and with Ω, and K6s/K7s and
    K6ms/K7ms (its shear builds), against their plain versions."""
    _zghost_kernels_match_plain(cuda, conv_slab(shape, **ZG_CASES[case]))


def _zghost_kernels_match_plain(cuda, cfg):
    """K6 and K7 of ``cfg``'s z-ghosted build and instance against their
    plain versions, each launched once under its own name."""
    pm = pt.Model(cfg, device=cuda)
    first_p, upd_p = fr.zg_plain(pm)
    inp = stratified_fg(pm)
    fr.reset_launches()
    df, dt1m = fr.rhs_zg(pm, *inp)
    df_p, dt1m_p = first_p(pm, *inp)
    torch.testing.assert_close(dt1m, dt1m_p, rtol=RTOL_DT, atol=0.0)
    assert_field_close(df, df_p, "df (K6)")
    alpha, beta, _ = pm.rk
    coef = torch.stack((pm._alpha[1], beta[1] / dt1m_p))
    inp2 = stratified_fg(pm, seed=5)
    df2, f2 = fr.rhs_zg_upd(pm, *inp2, df_p.clone(), coef)
    df2_p, f2_p = upd_p(pm, *inp2, df_p.clone(), coef)
    torch.cuda.synchronize()
    assert_field_close(df2, df2_p, "df (K7)")
    assert_field_close(f2, f2_p, "f (K7)")
    first, upd = fr.zg_kernels(pm)
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               **{first: 1, upd: 1})


@pytest.mark.parametrize("case", ZG_CASES)
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_zghost_update_in_place_equals_a_separate_df(cuda, shape, case):
    """K7 (K7m) with dfin and dfout as one buffer (the wrapper's contract:
    the new df over df_prev) gives, bit for bit, what it writes to a
    buffer of its own: no point's df store lands before its own df_prev
    load."""
    import ctypes
    from pencil_tpu_torch.ops import _build
    pm = pt.Model(conv_slab(shape, **ZG_CASES[case]), device=cuda)
    fa, zlo, zhi = stratified_fg(pm)
    df_prev, dt1m = fr.zg_plain(pm)[0](pm, fa, zlo, zhi)
    coef = torch.stack((pm._alpha[1], pm.rk[1][1] / dt1m))
    df_in, f_in = fr.rhs_zg_upd(pm, fa, zlo, zhi, df_prev.clone(), coef)
    df_out, f_out = torch.empty_like(df_prev), torch.empty_like(df_prev)
    prof_c, prof_h, grav = (t.data_ptr() for t in fr.zg_profiles(pm))
    assert _build.load(fr.zg_library(pm)).pc_rhs_tail_mid(
        ctypes.addressof(fr.kernel_params(pm)), fa.data_ptr(),
        df_prev.data_ptr(), coef.data_ptr(), df_out.data_ptr(),
        f_out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        zlo.data_ptr(), zhi.data_ptr(), prof_c, prof_h, None, grav,
        None) == 0
    torch.cuda.synchronize()
    assert torch.equal(df_in, df_out) and torch.equal(f_in, f_out)


@pytest.mark.parametrize("lib", sorted(fr.ZG_KERNELS))
def test_zghost_instances_hold_no_local_memory(cuda, lib):
    """K6 and K7 of fused_rhs_zg, K6m and K7m of fused_rhs_zg_mag, and
    those of the shear builds (K6s, K7s, K6ms, K7ms), each without and
    with rotation, chi-const and del6, and those of the builds without ss
    (K6i, K7i, K6mi, K7mi, K6si, K7si, K6msi, K7msi), each without and
    with rotation and del6, and each build's upwinding instances (_upw)
    beside the chi-const ones where it has them, and those of the builds
    with the shock slot (K6k, K7k, K6mk, K7mk), each with and without
    rotation, chi-const, the upwinding and the shock diffusivities (_sd),
    no del6: no spill and no stack, one 256-thread block per SM or
    more."""
    attrs = fr.flagship_attrs(lib)
    first, upd = fr.ZG_KERNELS[lib]
    chis = ("", "_chi") if lib in fr.ZG_CHI_LIBRARIES else ("",)
    shock = lib in fr.ZG_SHOCK_LIBRARIES
    flags = ("", "_upw") if shock else ("", "_h3", "_upw")
    sds = ("", "_sd") if shock else ("",)
    assert set(attrs) == {k + chi + flag + sd + rot for k in (first, upd)
                          for chi in chis for flag in flags for sd in sds
                          for rot in ("", " rot")}
    for name, a in attrs.items():
        assert a["local_bytes"] == 0, (name, a)
        assert a["blocks_per_sm"] >= 1, (name, a)


@pytest.mark.parametrize("case", ZG_CASES)
def test_conv_slab_steps_on_card_match_cpu(cuda, case):
    """Three zghost steps through K6/K7 (K6m/K7m; with Ω their Coriolis
    instances; with Shear K6s/K7s, K6ms/K7ms from t = 0.37; forced, the
    same draws kicked after each step) against the same steps on the CPU
    (plain versions) from the same fields.  The velocity and
    vector-potential noise is 1e-2, not the configuration's 1e-3 and 1e-4:
    a velocity that small is the residual of the O(1) hydrostatic balance
    and sits below its float32 floor (see tests/test_torch_zghost.py,
    UU_AMPL)."""
    _conv_slab_steps_match(cuda, conv_slab((16, 16, 32), **ZG_CASES[case]))


def _conv_slab_steps_match(cuda, cfg, noise=1e-2):
    """Three steps of a z-walled set on the card against the CPU from the
    same fields, u and A replaced by noise of amplitude ``noise``, and
    the same forcing draws."""
    shape = cfg.grid.shape
    if cfg.module("shear") is not None:
        cfg = cfg.replace(time=pt.TimeSpec(itorder=3, tstart=0.37))
    fields = dict(pt.Model(cfg, device="cpu").init_state(5)["fields"])
    g = torch.Generator().manual_seed(5)
    for k in ("uu", "aa"):
        if k in fields:
            fields[k] = noise * torch.randn((3,) + shape, generator=g)
    draws = [(torch.randint(0, 20, (1,), generator=g),
              torch.rand((), generator=g) * 6.0 - 3.0,
              torch.randn(3, generator=g)) for _ in range(3)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = pt.Model(cfg, device=dev)
        it = iter([tuple(t.to(dev) for t in d) for d in draws])
        model.forcing_draws = it.__next__
        s = model.make_multi_step(3)(model.init_state(5, overrides=fields))
        out[dev.type] = s
    torch.testing.assert_close(out["cuda"]["dt"].cpu(), out["cpu"]["dt"],
                               rtol=RTOL_DT, atol=0.0)
    for k, ref in out["cpu"]["fields"].items():
        a = out["cuda"]["fields"][k].cpu()
        assert_field_close(a[None] if a.ndim == 3 else a,
                           ref[None] if ref.ndim == 3 else ref, k)


def sheared_fg(pm, seed=4):
    """An x/y-ghosted shear-box stack of the model's layout on the card at
    t = 0.37: noisy fields (u, lnρ 1e-2, A 1e-4) and a positive shock slot
    where the layout has one, the x faces shifted by deltay."""
    g = torch.Generator(pm.device).manual_seed(seed)
    shape = pm.cfg.grid.shape
    nvar = pm.reg.nvar
    amp = torch.tensor([1e-4 if c[0] == "a" else 1e-2
                        for c in pm.reg.comp_names[:nvar]], device=pm.device)
    parts = [amp[:, None, None, None] * torch.randn(
        (nvar,) + shape, generator=g, device=pm.device)]
    if pm.reg.nf > nvar:
        parts.append(1e-3 * torch.rand((1,) + shape, generator=g,
                                       device=pm.device))
    sdy = pm.deltay(torch.tensor(0.37, device=pm.device))
    return pm.ghosted(torch.cat(parts), (0, 1), sdy)


# the shock builds' shapes: the last two are not multiples of the column,
# and the last also breaks every edge of the x-march (FLAGSHIP_SHAPES)
AUX_SHAPES = ((64, 64, 64), (32, 64, 128), (16, 24, 40), (24, 20, 42))
AUX_IDS = ("64^3", "32x64x128", "16x24x40", "24x20x42")


def _aux_kernels_match_plain(cuda, cfg, rtol):
    """K4 and K5 (the shear box) or K1s and K5w (the shocked box), of the
    build of ``cfg``'s layout, against their plain versions: each field
    within ``rtol`` × its max."""
    pm = pt.Model(cfg, device=cuda)
    if pm.mode == "zroll":
        make, kinds = sheared_fg, ("rhs_zroll", "rhs_zroll_upd")
    else:
        make, kinds = shocked_fa, ("rhs_wrap_shock", "rhs_wrap_shock_upd")
    names = fr.aux_kernels(pm)
    first, upd = (getattr(fr, k) for k in kinds)
    first_p, upd_p = (getattr(fr, k + "_plain") for k in kinds)
    fg = make(pm)
    nvar = pm.reg.nvar
    if pm.reg.nf > nvar:
        assert float(fg[nvar].max()) > 0.0
    fr.reset_launches()
    df, dt1m = first(pm, fg)
    df_p, dt1m_p = first_p(pm, fg)
    torch.testing.assert_close(dt1m, dt1m_p, rtol=RTOL_DT, atol=0.0)
    alpha, beta, _ = pm.rk
    coef = torch.stack((pm._alpha[1], beta[1] / dt1m_p))
    fg2 = make(pm, seed=5)
    got = {"df": df}
    want = {"df": df_p}
    got["df2"], got["f2"] = upd(pm, fg2, df_p.clone(), coef)
    want["df2"], want["f2"] = upd_p(pm, fg2, df_p.clone(), coef)
    torch.cuda.synchronize()
    for name in got:
        for c in range(nvar):
            err = float((got[name][c] - want[name][c]).abs().max())
            assert err <= rtol * max(float(want[name][c].abs().max()),
                                     1e-30), (name, c, err)
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               **dict.fromkeys(names, 1))


@pytest.mark.parametrize("shape", AUX_SHAPES, ids=AUX_IDS)
@pytest.mark.parametrize("case", MHD_ENT)
def test_mhd_entropy_kernels_match_plain(cuda, case, shape):
    """K1se/K5wse (within K1s/K5w's 1e-6), K4e/K5e and K4ne/K5ne (within
    K4/K5's 2e-5) against their plain versions at the shock builds'
    shapes."""
    make_cfg, rtol = BUILDS[case]
    _aux_kernels_match_plain(cuda, make_cfg(shape), rtol)


@pytest.mark.parametrize("shape", AUX_SHAPES, ids=AUX_IDS)
def test_zroll_kernels_match_plain(cuda, shape):
    """K4 and K5 against their plain versions."""
    _aux_kernels_match_plain(cuda, shear_box(shape), RTOL_FIELD)


def test_shear_box_steps_on_card_match_cpu(cuda):
    """Three zroll steps through K4/K5 against the same steps on the CPU
    (plain versions) from the same fields, starting at t = 0.37."""
    shape = (16, 16, 32)
    fields = pt.Model(shear_box(shape), device="cpu").init_state(5)["fields"]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = pt.Model(shear_box(shape), device=dev)
        s = model.init_state(5, overrides=fields)
        s["t"] = torch.full((), 0.37, device=dev)
        out[dev.type] = model.make_multi_step(3)(s)
    torch.testing.assert_close(out["cuda"]["dt"].cpu(), out["cpu"]["dt"],
                               rtol=RTOL_DT, atol=0.0)
    for k, ref in out["cpu"]["fields"].items():
        a = out["cuda"]["fields"][k].cpu()
        assert_field_close(a[None] if a.ndim == 3 else a,
                           ref[None] if ref.ndim == 3 else ref, k)


def shocked_fa(pm, seed=4):
    """A noisy shock-box state of the model's layout on the card, urms ≈
    1, lnρ 5e-2, s and A 1e-2, its shock slot built by the pre-pass
    (positive, so the shock viscosity is live)."""
    g = torch.Generator(pm.device).manual_seed(seed)
    shape = pm.cfg.grid.shape
    amp = torch.tensor([3 ** -0.5 if c[0] == "u" else 5e-2 if c == "lnrho"
                        else 0.0 if c == "shock" else 1e-2
                        for c in pm.reg.comp_names], device=pm.device)
    fa = amp[:, None, None, None] * torch.randn(
        (pm.reg.nf,) + shape, generator=g, device=pm.device)
    return pm._refresh_aux_fa(fa)


@pytest.mark.parametrize("shape", AUX_SHAPES, ids=AUX_IDS)
def test_shock_kernels_match_plain(cuda, shape):
    """K1s and K5w against their plain versions, within 1e-6 of each
    field's max (chip_smoke.py's bound)."""
    _aux_kernels_match_plain(cuda, shock_box(shape), 1e-6)


def test_shock_box_steps_on_card_match_cpu(cuda):
    """Three forced wrap_aux steps through K1s/K5w against the same steps
    on the CPU (plain versions) from the same fields and draws."""
    shape = (16, 16, 32)
    fields = dict(pt.Model(shock_box(shape),
                           device="cpu").init_state(5)["fields"])
    g = torch.Generator().manual_seed(6)
    fields["uu"] = 0.1 * torch.randn((3,) + shape, generator=g)
    draws = [(torch.randint(0, 20, (1,), generator=g),
              torch.rand((), generator=g) * 6.0 - 3.0,
              torch.randn(3, generator=g)) for _ in range(3)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = pt.Model(shock_box(shape), device=dev)
        it = iter([tuple(t.to(dev) for t in d) for d in draws])
        model.forcing_draws = it.__next__
        out[dev.type] = model.make_multi_step(3)(
            model.init_state(5, overrides=fields))
    torch.testing.assert_close(out["cuda"]["dt"].cpu(), out["cpu"]["dt"],
                               rtol=RTOL_DT, atol=0.0)
    for k, ref in out["cpu"]["fields"].items():
        a = out["cuda"]["fields"][k].cpu()
        assert_field_close(a[None] if a.ndim == 3 else a,
                           ref[None] if ref.ndim == 3 else ref, k)


def test_fake_rhs_chain_launches_k8(cuda):
    """Model(fake_rhs=True) runs K8's three variants and no other kernel."""
    pm = pt.Model(flagship((32, 32, 32), dt=1e-3), device=cuda,
                  fake_rhs=True)
    s = pm.pack_state(pm.init_state(0))
    fr.reset_launches()
    s = pm.make_step()(s)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               rhs_first_fake=1, rhs_tail_defer_fake=1,
                               rhs_tail_last_fake=1)
    assert torch.isfinite(s["_fa"]).all()


# ---- the other isothermal layouts of the shock and shear builds ------------
def aux_variant(cfg, omega, hyper3):
    """``cfg`` with Coriolis Ω about z, and with or without del6
    hyper-diffusion of u, lnρ (and A) at ν₃ = η₃ = D₃ = 5e-3·dx⁵: its
    ROT and H3 instances, picked on the host."""
    h3 = 5e-3 * cfg.grid.dx ** 5 if hyper3 else 0.0
    visc = cfg.module("viscosity")
    ivisc = tuple(v for v in visc.ivisc if v != "hyper3-simplified") + (
        ("hyper3-simplified",) if hyper3 else ())
    new = {"hydro": dict(Omega=omega), "density": dict(diffrho_hyper3=h3),
           "magnetic": dict(eta_hyper3=h3),
           "viscosity": dict(ivisc=ivisc, nu_hyper3=h3)}
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, **new[m.name]) if m.name in new else m
        for m in cfg.modules))


@pytest.mark.parametrize("hyper3", (False, True), ids=("plain", "h3"))
@pytest.mark.parametrize("omega", (0.0, 1.0), ids=("still", "rot"))
@pytest.mark.parametrize("shape", ((32, 32, 32), (24, 20, 42)),
                         ids=("32^3", "24x20x42"))
@pytest.mark.parametrize("case", NEW_AUX)
def test_new_aux_instances_match_plain(cuda, case, shape, omega, hyper3):
    """K1sh/K5wh, K4n/K5n, K4h/K5h, K4hn/K5hn, K1she/K5whe, K4he/K5he,
    K4hne/K5hne, K1se/K5wse, K4e/K5e and K4ne/K5ne, each instance
    (without and with Ω, without and with the del6 terms) against its
    plain version, counted under its build's launch names."""
    make_cfg, rtol = BUILDS[case]
    cfg = aux_variant(make_cfg(shape), omega, hyper3)
    p = fr.kernel_params(pt.Model(cfg, device="cpu"))
    assert (any(p.om), p.nu3 > 0.0) == (bool(omega), hyper3)
    _aux_kernels_match_plain(cuda, cfg, rtol)


@pytest.mark.parametrize("case", NEW_AUX)
def test_new_aux_steps_on_card_match_cpu(cuda, case):
    """Three steps of each new set through its kernels (the shear boxes
    from t = 0.37, the shocked boxes at urms ≈ 0.1, the forced sets with
    the same draws) against the same steps on the CPU."""
    cfg = BUILDS[case][0]((16, 16, 32))
    if case.startswith("shear"):
        _steps_match(cuda, cfg, t0=0.37)
    else:
        _steps_match(cuda, cfg, uu_noise=0.1)


@pytest.mark.parametrize("lib", sorted(
    set(fr.AUX_KERNELS) - {"fused_rhs_shock", "fused_rhs_shear"}))
def test_new_aux_instances_hold_no_local_memory(cuda, lib):
    """Every instance of the ten newer builds (first and update, with
    and without Ω and the del6 terms, and with and without Ω the
    upwinding; with the shock slot each also with the shock
    diffusivities): no spill and no stack, one 256-thread block per SM or
    more, its shared memory within a block's 227 KB."""
    attrs = fr.flagship_attrs(lib)
    assert len(attrs) == (12 if lib.endswith("_ns") else 24)
    for name, a in attrs.items():
        assert a["local_bytes"] == 0, (name, a)
        assert a["blocks_per_sm"] >= 1, (name, a)
        assert a["static_smem"] + a["dynamic_smem"] <= 232448, (name, a)
        assert 0 < a["registers"] <= 255, (name, a)


# ---- the H3 and CHI instances -----------------------------------------------
# the four periodic sets with del6 hyper-diffusion (their H3 instances)
H3_CASES = {
    "mhd": lambda shape, **kw: pt.configs.flagship(shape, hyper3=True),
    "hydro": lambda shape, **kw: forced_hydro(shape, hyper3=True, **kw),
    "ent_mhd": lambda shape, **kw: forced_entropy(shape, hyper3=True, **kw),
    "ent_hydro": lambda shape, **kw: forced_entropy(
        shape, magnetic=False, hyper3=True, **kw)}


@pytest.mark.parametrize("omega", (0.0, 1.0), ids=("still", "rot"))
@pytest.mark.parametrize("shape", ((32, 32, 32), (24, 20, 42)),
                         ids=("32^3", "24x20x42"))
@pytest.mark.parametrize("case", sorted(H3_CASES))
def test_h3_instances_match_plain(cuda, case, shape, omega):
    """K1, K2, K3 and K2L with and without the kick, and K3′ of each
    periodic build with del6 hyper-diffusion (the H3 instances, with Ω
    their Coriolis H3 instances) against their plain versions, counted
    under the launch names with _h3: each field within 2e-5 × its max,
    the CFL maximum within 1e-6 relative."""
    cfg = H3_CASES[case](shape)
    if omega:
        cfg = with_omega(cfg, omega)
    assert fr.launch_suffix(pt.Model(cfg, device="cpu")).endswith("_h3")
    _template_instances_match_plain(cuda, cfg, RTOL_FIELD)


@pytest.mark.parametrize("case", sorted(H3_CASES))
def test_h3_steps_on_card_match_cpu(cuda, case):
    """Three forced steps of each periodic set with hyper-diffusion on the
    card against the same steps on the CPU."""
    _steps_match(cuda, H3_CASES[case]((16, 16, 32)))


@pytest.mark.parametrize("lib", sorted(fr.WRAP_LIBRARIES))
def test_h3_instances_hold_no_local_memory(cuda, lib):
    """Every instance of the four periodic builds, the H3 ones included:
    no spill and no stack, one 256-thread block per SM or more."""
    attrs = fr.flagship_attrs(lib)
    assert sum(name.split()[0].endswith("_h3") for name in attrs) == 14
    for name, a in attrs.items():
        assert a["local_bytes"] == 0, (name, a)
        assert a["blocks_per_sm"] >= 1, (name, a)


# the conv-slab sets with chi-const beside K-const (the CHI instances)
CHI_CASES = {"chi": dict(chi=4e-3), "chi_rot": dict(chi=4e-3, Omega=1.0),
             "mag_chi": dict(magnetic=True, chi=4e-3),
             "mag_chi_rot": dict(magnetic=True, chi=4e-3, Omega=1.0),
             "shear_chi": dict(chi=4e-3, Omega=1.0, shear=True),
             "mag_shear_chi": dict(magnetic=True, chi=4e-3, Omega=1.0,
                                   shear=True)}


@pytest.mark.parametrize("case", CHI_CASES)
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_chi_instances_match_plain(cuda, shape, case):
    """K6 and K7 (K6m and K7m) with chi-const, without and with Ω, against
    their plain versions, counted under the launch names with _chi."""
    cfg = conv_slab(shape, **CHI_CASES[case])
    assert fr.zg_kernels(pt.Model(cfg, device="cpu"))[0].endswith("_chi")
    _zghost_kernels_match_plain(cuda, cfg)


@pytest.mark.parametrize("case", CHI_CASES)
def test_chi_steps_on_card_match_cpu(cuda, case):
    """Three zghost steps with chi-const on the card against the same
    steps on the CPU."""
    _conv_slab_steps_match(cuda, conv_slab((16, 16, 32), **CHI_CASES[case]))


# the conv-slab sets with del6 hyper-diffusion (the z-ghosted H3
# instances), with Ω and with chi-const beside it
ZG_H3_CASES = {"h3": dict(hyper3=True), "h3_rot": dict(hyper3=True,
                                                       Omega=1.0),
               "chi_h3": dict(hyper3=True, chi=4e-3),
               "mag_h3": dict(magnetic=True, hyper3=True),
               "mag_h3_rot": dict(magnetic=True, hyper3=True, Omega=1.0),
               "mag_chi_h3_rot": dict(magnetic=True, hyper3=True, chi=4e-3,
                                      Omega=1.0),
               "shear_h3": dict(hyper3=True, Omega=1.0, shear=True),
               "shear_chi_h3": dict(hyper3=True, chi=4e-3, Omega=1.0,
                                    shear=True),
               "mag_shear_h3": dict(magnetic=True, hyper3=True, Omega=1.0,
                                    shear=True),
               "mag_shear_chi_h3": dict(magnetic=True, hyper3=True,
                                        chi=4e-3, Omega=1.0, shear=True)}


@pytest.mark.parametrize("case", ZG_H3_CASES)
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_zg_h3_instances_match_plain(cuda, shape, case):
    """K6 and K7 (K6m and K7m) with del6, without and with Ω and
    chi-const, against their plain versions, counted under the launch
    names with _h3."""
    cfg = conv_slab(shape, **ZG_H3_CASES[case])
    assert fr.zg_kernels(pt.Model(cfg, device="cpu"))[0].endswith("_h3")
    _zghost_kernels_match_plain(cuda, cfg)


@pytest.mark.parametrize("case", ZG_H3_CASES)
def test_zg_h3_steps_on_card_match_cpu(cuda, case):
    """Three zghost steps with del6 on the card against the same steps on
    the CPU."""
    _conv_slab_steps_match(cuda, conv_slab((16, 16, 32),
                                           **ZG_H3_CASES[case]))


# ---- the isothermal stratified layer (the z-ghosted builds without ss) -----
# strat_box keyword arguments: K6i/K7i, K6mi/K7mi (constant gravity), their
# Coriolis instances, K6si/K7si and K6msi/K7msi (g_z = -z, Ω = 1), the H3
# instances, and a forced case (the kernels of the unforced set)
ISO_CASES = {"iso": dict(magnetic=False, shear=False),
             "iso_rot": dict(magnetic=False, shear=False, rot=1.0),
             "iso_mag": dict(shear=False),
             "iso_mag_rot_h3": dict(shear=False, rot=1.0, hyper3=True),
             "iso_shear": dict(magnetic=False),
             "iso_mag_shear": {},
             "iso_shear_h3": dict(magnetic=False, hyper3=True),
             "iso_mag_shear_h3": dict(hyper3=True),
             "iso_mag_forced": dict(shear=False, forcing=0.05)}


def iso_cfg(shape, case):
    """strat_box of ``case``, with Ω about z where it has ``rot``, the
    sheared ones from t = 0.37."""
    kw = dict(ISO_CASES[case])
    rot = kw.pop("rot", 0.0)
    cfg = strat_box(shape, **kw)
    if rot:
        cfg = cfg.replace(modules=tuple(
            pt.Hydro(init=m.init, ampl=m.ampl, Omega=rot)
            if m.name == "hydro" else m for m in cfg.modules))
    if cfg.module("shear") is not None:
        cfg = cfg.replace(time=pt.TimeSpec(itorder=3, tstart=0.37))
    return cfg


def iso_fg(pm, seed=4):
    """An isothermal stratified state on the card as the z-ghosted
    kernels take it (``Model.zg_input``): the hydrostatic lnρ with noise,
    noisy u and, with Magnetic, A (1e-2 each); with Shear ghosted in x and
    y with the x faces shifted by deltay at t = 0.37."""
    g = torch.Generator(pm.device).manual_seed(seed)
    f = pm.init_state(0)["fields"]
    shape = pm.cfg.grid.shape

    def noise(sh):
        return 1e-2 * torch.randn(sh, generator=g, device=pm.device)

    parts = [noise((3,) + shape), (f["lnrho"] + noise(shape))[None]]
    if "aa" in pm.reg.slots:
        parts.append(noise((3,) + shape))
    sdy = (pm.deltay(torch.tensor(0.37, device=pm.device))
           if pm.shear is not None else None)
    return pm.zg_input(torch.cat(parts).contiguous(), sdy)


@pytest.mark.parametrize("case", ISO_CASES)
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_iso_kernels_match_plain(cuda, shape, case):
    """K6i/K7i, K6mi/K7mi, K6si/K7si and K6msi/K7msi, with and without Ω
    and del6, against their plain versions, each launched once under its
    own name."""
    pm = pt.Model(iso_cfg(shape, case), device=cuda)
    first_p, upd_p = fr.zg_plain(pm)
    inp = iso_fg(pm)
    fr.reset_launches()
    df, dt1m = fr.rhs_zg(pm, *inp)
    df_p, dt1m_p = first_p(pm, *inp)
    torch.testing.assert_close(dt1m, dt1m_p, rtol=RTOL_DT, atol=0.0)
    assert_field_close(df, df_p, "df (K6i)")
    coef = torch.stack((pm._alpha[1], pm.rk[1][1] / dt1m_p))
    inp2 = iso_fg(pm, seed=5)
    df2, f2 = fr.rhs_zg_upd(pm, *inp2, df_p.clone(), coef)
    df2_p, f2_p = upd_p(pm, *inp2, df_p.clone(), coef)
    torch.cuda.synchronize()
    assert_field_close(df2, df2_p, "df (K7i)")
    assert_field_close(f2, f2_p, "f (K7i)")
    first, upd = fr.zg_kernels(pm)
    assert "_iso" in first and "_chi" not in first
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               **{first: 1, upd: 1})


@pytest.mark.parametrize("case", ISO_CASES)
def test_iso_steps_on_card_match_cpu(cuda, case):
    """Three zghost steps of each isothermal stratified set on its build
    without ss (forced: the same draws kicked after each step) against
    the same steps on the CPU from the same fields, u and A with noise of
    1e-2."""
    _conv_slab_steps_match(cuda, iso_cfg((16, 16, 32), case))


# ---- gravity on every chain ---------------------------------------------------
def with_gravity(cfg, profile):
    """``cfg`` with Gravity of ``profile`` in place of its own, or added:
    g_z = −1 ('const'), −z ('linear-z'), −sin(2πz/Lz) ('sin-z')."""
    import math
    kw = {"const": dict(gravz=-1.0), "linear-z": dict(gravz=-1.0),
          "sin-z": dict(gravz=-1.0,
                        kappa_z=2.0 * math.pi / cfg.grid.Lz)}[profile]
    grav = pt.Gravity(gravz_profile=profile, **kw)
    rest = tuple(m for m in cfg.modules if m.name != "gravity")
    return cfg.replace(modules=rest + (grav,))


# every library of the template with a gravity profile: (the library's
# configuration, its profile)
GRAV_WRAP = {"mhd": (lambda s: flagship(s), "sin-z"),
             "hydro": (lambda s: forced_hydro(s), "const"),
             "ent_mhd": (lambda s: forced_entropy(s), "linear-z"),
             "ent_hydro": (lambda s: forced_entropy(s, magnetic=False),
                           "sin-z"),
             "mhd_h3": (lambda s: pt.configs.flagship(s, hyper3=True),
                        "const")}
GRAV_AUX = {build: (BUILDS[build][0], prof) for build, prof in zip(
    AUX_BUILDS, ("sin-z", "const", "linear-z") * 4)}
GRAV_ZG = {"conv_slab_linear": (dict(), "linear-z"),
           "conv_slab_sin_rot": (dict(Omega=1.0), "sin-z"),
           "mag_linear_chi": (dict(magnetic=True, chi=4e-3), "linear-z"),
           "mag_sin_h3": (dict(magnetic=True, hyper3=True), "sin-z"),
           "shear_linear": (dict(Omega=1.0, shear=True), "linear-z"),
           "shear_sin_chi": (dict(Omega=1.0, shear=True, chi=4e-3),
                             "sin-z"),
           "mag_shear_linear": (dict(magnetic=True, Omega=1.0, shear=True),
                                "linear-z"),
           "mag_shear_sin_h3": (dict(magnetic=True, Omega=1.0, shear=True,
                                     hyper3=True), "sin-z")}
GRAV_ISO = {case: "sin-z" for case in ("iso", "iso_mag", "iso_shear",
                                       "iso_mag_shear")}


@pytest.mark.parametrize("shape", ((32, 32, 32), (24, 20, 42)),
                         ids=("32^3", "24x20x42"))
@pytest.mark.parametrize("case", sorted(GRAV_WRAP))
def test_gravity_wrap_instances_match_plain(cuda, case, shape):
    """K1, K2, K3, K3′ and K2L of each periodic build under gravity
    against their plain versions (within 2e-5 × each field's max)."""
    make, prof = GRAV_WRAP[case]
    pm = pt.Model(with_gravity(make(shape), prof), device="cpu")
    assert fr.gravity_vector(pm) is not None
    _template_instances_match_plain(cuda, with_gravity(make(shape), prof),
                                    RTOL_FIELD)


@pytest.mark.parametrize("shape", ((32, 32, 32), (24, 20, 42)),
                         ids=("32^3", "24x20x42"))
@pytest.mark.parametrize("build", sorted(GRAV_AUX))
def test_gravity_aux_instances_match_plain(cuda, build, shape):
    """The first and update kernel of each shock and shear build under
    gravity against their plain versions, within their builds' bounds."""
    make, prof = GRAV_AUX[build]
    _aux_kernels_match_plain(cuda, with_gravity(make(shape), prof),
                             BUILDS[build][1])


@pytest.mark.parametrize("case", sorted(GRAV_ZG))
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_gravity_zg_instances_match_plain(cuda, shape, case):
    """K6/K7, K6m/K7m, K6s/K7s and K6ms/K7ms (and their ROT, CHI and H3
    instances) under 'linear-z' and 'sin-z' against their plain
    versions."""
    kw, prof = GRAV_ZG[case]
    _zghost_kernels_match_plain(cuda, with_gravity(conv_slab(shape, **kw),
                                                   prof))


@pytest.mark.parametrize("case", sorted(GRAV_ISO))
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_gravity_iso_instances_match_plain(cuda, shape, case):
    """K6i/K7i … K6msi/K7msi under 'sin-z' against their plain
    versions."""
    pm = pt.Model(with_gravity(iso_cfg(shape, case), GRAV_ISO[case]),
                  device=cuda)
    first_p, upd_p = fr.zg_plain(pm)
    inp = iso_fg(pm)
    df, dt1m = fr.rhs_zg(pm, *inp)
    df_p, dt1m_p = first_p(pm, *inp)
    torch.testing.assert_close(dt1m, dt1m_p, rtol=RTOL_DT, atol=0.0)
    assert_field_close(df, df_p, "df (K6i)")
    coef = torch.stack((pm._alpha[1], pm.rk[1][1] / dt1m_p))
    df2, f2 = fr.rhs_zg_upd(pm, *inp, df_p.clone(), coef)
    df2_p, f2_p = upd_p(pm, *inp, df_p.clone(), coef)
    assert_field_close(df2, df2_p, "df (K7i)")
    assert_field_close(f2, f2_p, "f (K7i)")


# the two new paths: the stratified shearing box with an energy equation,
# MHD and hydro, and forced stratified turbulence in a periodic box
GRAV_PATHS = {"strat_ent": dict(entropy=True),
              "strat_ent_hydro": dict(entropy=True, magnetic=False),
              "strat_periodic": dict(periodic=True, shear=False,
                                     forcing=0.05),
              "strat_periodic_hydro": dict(periodic=True, shear=False,
                                           magnetic=False, forcing=0.05)}


@pytest.mark.parametrize("case", sorted(GRAV_PATHS))
def test_gravity_paths_on_card_match_cpu(cuda, case):
    """Three steps of each new path on the card against the same steps on
    the CPU from the same fields (u and A with noise of 1e-2; the sheared
    ones from t = 0.37) and forcing draws."""
    _conv_slab_steps_match(cuda, strat_box((16, 16, 32), **GRAV_PATHS[case]))


# ---- B_ext and the continuous forcing on every build ---------------------------
FCONT = ("ABC", "RobertsFlow", "cosx*cosy*cosz", "xz")
B_EXT = (0.03, -0.05, 0.1)


def with_terms(cfg, profile):
    """``cfg`` with B_ext (its MHD sets) and the continuous forcing
    ``profile`` at k1_ff = 1, its maximum 0.1, on its Forcing module or a
    new one without kicks."""
    gs = cfg.grid
    ampl = 0.1 / ((gs.Lx / 2) ** 2 * (gs.Lz / 2) ** 2) if profile == "xz" \
        else 0.1
    kw = dict(lforcing_cont=True, iforcing_cont=profile, ampl_ff=ampl,
              k1_ff=1.0, fcont_box=(gs.x0, gs.x0 + gs.Lx, gs.z0,
                                    gs.z0 + gs.Lz))
    mods = tuple(dataclasses.replace(m, B_ext=B_EXT) if m.name == "magnetic"
                 else dataclasses.replace(m, **kw) if m.name == "forcing"
                 else m for m in cfg.modules)
    if cfg.module("forcing") is None:
        mods += (pt.Forcing(force=0.0, **kw),)
    return cfg.replace(modules=mods)


TERM_WRAP = {"mhd": lambda s: flagship(s),
             "hydro": lambda s: forced_hydro(s),
             "ent_mhd": lambda s: forced_entropy(s),
             "ent_hydro": lambda s: forced_entropy(s, magnetic=False),
             "mhd_h3_rot": lambda s: with_omega(
                 pt.configs.flagship(s, hyper3=True), 1.0)}



@pytest.mark.parametrize("shape", ((32, 32, 32), (24, 20, 42)),
                         ids=("32^3", "24x20x42"))
@pytest.mark.parametrize("case", sorted(TERM_WRAP))
def test_terms_wrap_instances_match_plain(cuda, case, shape):
    """K1, K2, K3, K3′ and K2L of each periodic build with the continuous
    forcing (a profile each) and, on the MHD builds, B_ext against their
    plain versions."""
    cfg = with_terms(TERM_WRAP[case](shape),
                     FCONT[sorted(TERM_WRAP).index(case) % 4])
    assert fr.fcont_tensor(pt.Model(cfg, device="cpu")) is not None
    _template_instances_match_plain(cuda, cfg, RTOL_FIELD)


@pytest.mark.parametrize("shape", ((32, 32, 32), (24, 20, 42)),
                         ids=("32^3", "24x20x42"))
@pytest.mark.parametrize("build", sorted(AUX_BUILDS))
def test_terms_aux_instances_match_plain(cuda, build, shape):
    """The first and update kernel of each shock and shear build with the
    continuous forcing and, on the MHD builds, B_ext, within their
    builds' bounds."""
    make, rtol = BUILDS[build]
    _aux_kernels_match_plain(cuda, with_terms(
        make(shape), FCONT[AUX_BUILDS.index(build) % 4]), rtol)


@pytest.mark.parametrize("case", sorted(ZG_CASES))
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_terms_zg_instances_match_plain(cuda, shape, case):
    """K6/K7, K6m/K7m, K6s/K7s and K6ms/K7ms with the continuous forcing
    and, with Magnetic, B_ext against their plain versions."""
    _zghost_kernels_match_plain(cuda, with_terms(
        conv_slab(shape, **ZG_CASES[case]),
        FCONT[sorted(ZG_CASES).index(case) % 4]))


@pytest.mark.parametrize("case", ISO_CASES)
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_terms_iso_instances_match_plain(cuda, shape, case):
    """K6i/K7i … K6msi/K7msi with the continuous forcing and, with
    Magnetic, B_ext against their plain versions."""
    pm = pt.Model(with_terms(iso_cfg(shape, case),
                             FCONT[list(ISO_CASES).index(case) % 4]),
                  device=cuda)
    first_p, upd_p = fr.zg_plain(pm)
    inp = iso_fg(pm)
    df, dt1m = fr.rhs_zg(pm, *inp)
    df_p, dt1m_p = first_p(pm, *inp)
    torch.testing.assert_close(dt1m, dt1m_p, rtol=RTOL_DT, atol=0.0)
    assert_field_close(df, df_p, "df (K6i)")
    coef = torch.stack((pm._alpha[1], pm.rk[1][1] / dt1m_p))
    df2, f2 = fr.rhs_zg_upd(pm, *inp, df_p.clone(), coef)
    df2_p, f2_p = upd_p(pm, *inp, df_p.clone(), coef)
    assert_field_close(df2, df2_p, "df (K7i)")
    assert_field_close(f2, f2_p, "f (K7i)")


# the four new paths: imposed-field MHD turbulence, the NEMPI box, the
# ABC-flow dynamo and the Roberts flow
TERM_PATHS = {
    "bext": lambda s: pt.configs.flagship(s, b_ext=(0.0, 0.0, 0.1)),
    "nempi": lambda s: strat_box(s, shear=False, forcing=0.05,
                                 b_ext=(0.0, pt.configs.NEMPI_B0, 0.0)),
    "abc": lambda s: pt.configs.flagship(s, fcont=("ABC", 0.1, 1.0)),
    "roberts": lambda s: forced_hydro(s, fcont=("RobertsFlow", 0.1, 1.0))}


@pytest.mark.parametrize("case", sorted(TERM_PATHS))
def test_term_paths_on_card_match_cpu(cuda, case):
    """Three steps of each new path on the card against the same steps on
    the CPU from the same fields and forcing draws."""
    _conv_slab_steps_match(cuda, TERM_PATHS[case]((16, 16, 32)))


# ---- upwinding and the shock diffusivities ---------------------------------------
@pytest.mark.parametrize("omega", (0.0, 1.0), ids=("still", "rot"))
@pytest.mark.parametrize("shape", ((32, 32, 32), (24, 20, 42)),
                         ids=("32^3", "24x20x42"))
@pytest.mark.parametrize("case", ("mhd", "hydro", "ent_mhd", "ent_hydro"))
def test_upw_wrap_instances_match_plain(cuda, case, shape, omega):
    """K1, K2, K3 and K2L with and without the kick, and K3′ of each
    periodic build with the lupw flags on (the UPW instances, with Ω
    their Coriolis UPW instances) against their plain versions, counted
    under the launch names with _upw."""
    cfg = with_upwind(TERM_WRAP[case](shape))
    if omega:
        cfg = with_omega(cfg, omega)
    assert fr.launch_suffix(pt.Model(cfg, device="cpu")).endswith("_upw")
    _template_instances_match_plain(cuda, cfg, RTOL_FIELD)


@pytest.mark.parametrize("omega", (0.0, 1.0), ids=("still", "rot"))
@pytest.mark.parametrize("shape", ((32, 32, 32), (24, 20, 42)),
                         ids=("32^3", "24x20x42"))
@pytest.mark.parametrize("build", sorted(AUX_BUILDS))
def test_upw_aux_instances_match_plain(cuda, build, shape, omega):
    """The first and update kernel of each shock and shear build with the
    lupw flags on (del6 off), with and without Ω, within their builds'
    bounds."""
    make, rtol = BUILDS[build]
    _aux_kernels_match_plain(cuda, with_upwind(aux_variant(
        make(shape), omega, False)), rtol)


@pytest.mark.parametrize("case", ("conv_slab", "rot", "mag", "mag_rot",
                                  "shear", "mag_shear"))
@pytest.mark.parametrize("chi", (0.0, 4e-3), ids=("K", "chi"))
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_upw_zg_instances_match_plain(cuda, shape, chi, case):
    """K6/K7, K6m/K7m, K6s/K7s and K6ms/K7ms with lnρ, u and s upwinded,
    with and without Ω and chi-const, against their plain versions."""
    _zghost_kernels_match_plain(cuda, conv_slab(
        shape, upwind=True, chi=chi, **ZG_CASES[case]))


@pytest.mark.parametrize("case", ("iso", "iso_rot", "iso_mag", "iso_shear",
                                  "iso_mag_shear"))
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_upw_iso_instances_match_plain(cuda, shape, case):
    """K6i/K7i … K6msi/K7msi with lnρ and u upwinded against their plain
    versions."""
    pm = pt.Model(with_upwind(iso_cfg(shape, case)), device=cuda)
    first_p, upd_p = fr.zg_plain(pm)
    inp = iso_fg(pm)
    df, dt1m = fr.rhs_zg(pm, *inp)
    df_p, dt1m_p = first_p(pm, *inp)
    torch.testing.assert_close(dt1m, dt1m_p, rtol=RTOL_DT, atol=0.0)
    assert_field_close(df, df_p, "df (K6i upw)")
    coef = torch.stack((pm._alpha[1], pm.rk[1][1] / dt1m_p))
    df2, f2 = fr.rhs_zg_upd(pm, *inp, df_p.clone(), coef)
    df2_p, f2_p = upd_p(pm, *inp, df_p.clone(), coef)
    assert_field_close(df2, df2_p, "df (K7i upw)")
    assert_field_close(f2, f2_p, "f (K7i upw)")


@pytest.mark.parametrize("hyper3, upwind", ((False, False), (True, False),
                                            (False, True)),
                         ids=("plain", "h3", "upw"))
@pytest.mark.parametrize("omega", (0.0, 1.0), ids=("still", "rot"))
@pytest.mark.parametrize("build", ("shock", "shear", "shock_hydro",
                                   "shear_hydro", "shock_hydro_ent",
                                   "shear_hydro_ent", "shock_ent",
                                   "shear_ent"))
def test_shock_diffusion_instances_match_plain(cuda, build, omega, hyper3,
                                               upwind):
    """Every instance of the 8 builds with the shock slot with D_sh, η_sh
    (MHD) and χ_sh (with ss) on, against its plain version at 24×20×42
    (the UPW instances without del6)."""
    make, rtol = BUILDS[build]
    cfg = with_shock_diffusion(aux_variant(make((24, 20, 42)), omega,
                                           hyper3))
    _aux_kernels_match_plain(cuda, with_upwind(cfg) if upwind else cfg,
                             rtol)


# the four new paths: forced MHD turbulence and stratified convection
# upwinded, the shocked boxes with the whole shock-capturing set
OPTION_PATHS = {
    "flagship_upwind": lambda s: pt.configs.flagship(s, upwind=True),
    "conv_slab_upwind": lambda s: conv_slab(s, upwind=True),
    "shock_box_ent_sd": lambda s: shock_box(s, entropy=True,
                                            shock_diffusion=True),
    "hydro_shock_box_sd": lambda s: shock_box(s, magnetic=False,
                                              shock_diffusion=True)}


@pytest.mark.parametrize("case", sorted(OPTION_PATHS))
def test_option_paths_on_card_match_cpu(cuda, case):
    """Three steps of each new path on the card against the same steps on
    the CPU from the same fields and forcing draws."""
    cfg = OPTION_PATHS[case]((16, 16, 32))
    if case.startswith("conv"):
        _conv_slab_steps_match(cuda, cfg)
    elif "shock" in case:
        _steps_match(cuda, cfg, uu_noise=0.1)
    else:
        _steps_match(cuda, cfg)


def test_card_refuses_upwinding_beside_hyper3(cuda):
    """lupw flags beside a del6 coefficient raise before any launch."""
    fr.reset_launches()
    with pytest.raises(NotImplementedError, match="hyper3"):
        pt.Model(pt.configs.flagship(32, hyper3=True, upwind=True),
                 device=cuda)
    assert not any(fr.LAUNCHES.values())


@pytest.mark.parametrize("which", ("flagship", "rk2", "rk4", "conv_slab",
                                   "conv_slab_rot", "conv_slab_mag",
                                   "conv_slab_mag_rot", "conv_slab_shear",
                                   "conv_slab_mag_shear", "conv_slab_forced",
                                   "conv_slab_forced_mag_shear",
                                   "shear_box", "shock_box", "hydro",
                                   "hydro_rk2", "hydro_rk4", "ent_mhd",
                                   "ent_mhd_rk2", "ent_mhd_rk4",
                                   "ent_hydro", "ent_hydro_rk2",
                                   "ent_hydro_rk4", "flagship_h3",
                                   "conv_slab_mag_chi", "conv_slab_h3",
                                   "conv_slab_mag_chi_h3_rot", *NEW_AUX,
                                   *ISO_CASES, *GRAV_PATHS, *TERM_PATHS))
def test_cuda_tensors_never_take_the_plain_path(cuda, monkeypatch, which):
    """A CUDA tensor launches the kernel; the plain version is not called."""
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")
    for name in dir(fr):
        if name.startswith("rhs_") and name.endswith("_plain"):
            monkeypatch.setattr(fr, name, boom)
    n3 = (32, 32, 32)
    cfg = {"flagship": flagship(n3), "rk2": flagship(n3, 2),
           "rk4": flagship(n3, 4), "conv_slab": conv_slab(32),
           **{"conv_slab_" + k: conv_slab(32, **kw)
              for k, kw in ZG_CASES.items() if kw},
           "shear_box": shear_box(32), "shock_box": shock_box(32),
           "hydro": forced_hydro(32),
           "hydro_rk2": forced_hydro(32).replace(time=pt.TimeSpec(itorder=2)),
           "hydro_rk4": forced_hydro(32).replace(
               time=pt.TimeSpec(itorder=4)),
           "flagship_h3": pt.configs.flagship(32, hyper3=True),
           "conv_slab_mag_chi": conv_slab(32, magnetic=True, chi=4e-3),
           **{"conv_slab_" + k: conv_slab(32, **ZG_H3_CASES[k])
              for k in ("h3", "mag_chi_h3_rot")},
           **{k: BUILDS[k][0](32) for k in NEW_AUX},
           **{k: iso_cfg(32, k) for k in ISO_CASES},
           **{k: strat_box(32, **kw) for k, kw in GRAV_PATHS.items()},
           **{k: make(32) for k, make in TERM_PATHS.items()}}
    for name, magnetic in (("ent_mhd", True), ("ent_hydro", False)):
        for order in (3, 2, 4):
            cfg[name + ("" if order == 3 else f"_rk{order}")] = \
                forced_entropy(32, magnetic=magnetic).replace(
                    time=pt.TimeSpec(itorder=order))
    cfg = cfg[which]
    pm = pt.Model(cfg, device=cuda)
    s = pm.make_step()(pm.init_state(0))
    torch.cuda.synchronize()
    assert torch.isfinite(s["fields"]["uu"]).all()



# the z-ghosted builds with the shock slot: conv_slab keyword arguments
ZG_SHOCK_CASES = {"conv": dict(shock=True),
                  "mag": dict(shock=True, magnetic=True)}


@pytest.mark.parametrize("sd", (False, True), ids=("nu_sh", "sd"))
@pytest.mark.parametrize("upwind", (False, True), ids=("plain", "upw"))
@pytest.mark.parametrize("chi", (0.0, 4e-3), ids=("K", "chi"))
@pytest.mark.parametrize("omega", (0.0, 1.0), ids=("still", "rot"))
@pytest.mark.parametrize("case", sorted(ZG_SHOCK_CASES))
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_zg_shock_instances_match_plain(cuda, shape, case, omega, chi,
                                        upwind, sd):
    """K6k/K7k and K6mk/K7mk, every instance (with and without Ω,
    chi-const, the upwinding and the shock diffusivities), on the interior
    stack of all slots with a positive shock profile and its z slabs,
    against their plain versions."""
    cfg = conv_slab(shape, Omega=omega, chi=chi, upwind=upwind,
                    **ZG_SHOCK_CASES[case])
    _zghost_kernels_match_plain(cuda, with_shock_diffusion(cfg) if sd
                                else cfg)


@pytest.mark.parametrize("sd", (False, True), ids=("nu_sh", "sd"))
@pytest.mark.parametrize("case", sorted(ZG_SHOCK_CASES))
def test_zg_shock_steps_on_card_match_cpu(cuda, case, sd):
    """Three steps of the shocked conv-slab and magnetoconvection (the
    shock pre-pass before each kernel) on the card against the CPU."""
    cfg = conv_slab((16, 16, 32), **ZG_SHOCK_CASES[case])
    _conv_slab_steps_match(cuda, with_shock_diffusion(cfg) if sd else cfg)


def test_highorder_shock_box_steps_on_card_match_cpu(cuda):
    """Three steps of the shocked box with the 'highorder' profile
    (K1s/K5w) on the card against the CPU from the same fields and
    draws."""
    cfg = shock_box(32)
    _steps_match(cuda, cfg.replace(modules=tuple(
        dataclasses.replace(m, variant="highorder") if m.name == "shock"
        else m for m in cfg.modules)), uu_noise=0.1)


# ---- SAFI, the mesh flavour of del6 and the mean removal -------------------
def with_safi(cfg):
    """``cfg`` with its Shear's advection as a shift between substeps."""
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, lshearadvection_as_shift=True)
        if m.name == "shear" else m for m in cfg.modules))


def with_mesh(cfg):
    """``cfg`` with the mesh flavour of del6 on u and lnρ in place of the
    'simplified' one (η₃ stays on A)."""
    c = pt.configs.MESH_HYPER3
    new = {"viscosity": lambda m: dict(
               ivisc=tuple(v for v in m.ivisc if v != "hyper3-simplified")
               + ("hyper3-mesh",), nu_hyper3=0.0, nu_hyper3_mesh=c),
           "density": lambda m: dict(diffrho_hyper3=0.0,
                                     diffrho_hyper3_mesh=c)}
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, **new[m.name](m)) if m.name in new else m
        for m in cfg.modules))


SHEAR_AUX = tuple(b for b in AUX_BUILDS if b.startswith("shear"))


@pytest.mark.parametrize("mesh", (False, True), ids=("plain", "mesh"))
@pytest.mark.parametrize("shape", ((32, 32, 32), (24, 20, 42)),
                         ids=("32^3", "24x20x42"))
@pytest.mark.parametrize("build", SHEAR_AUX)
def test_safi_shear_kernels_match_plain(cuda, build, shape, mesh):
    """K4/K5 of each shear build with the flow's nodes at 0 (SAFI), with
    del6 simplified or, ``mesh``, in its mesh flavour, against their plain
    versions (which drop the advection and its CFL term)."""
    cfg = with_safi(BUILDS[build][0](shape))
    if mesh:
        cfg = with_mesh(cfg)
    pm = pt.Model(cfg, device=cuda)
    p = fr.kernel_params(pm)
    assert p.x0 == p.dx == 0.0 and p.S != 0.0
    _aux_kernels_match_plain(cuda, cfg, RTOL_FIELD)


@pytest.mark.parametrize("shape", ((32, 32, 32), (24, 20, 42)),
                         ids=("32^3", "24x20x42"))
@pytest.mark.parametrize("build", sorted(set(AUX_BUILDS) - set(SHEAR_AUX)))
def test_mesh_shock_kernels_match_plain(cuda, build, shape):
    """K1s/K5w of each shocked build's H3 instance with the mesh weights
    against their plain versions."""
    _aux_kernels_match_plain(
        cuda, with_mesh(_with_h3(BUILDS[build][0](shape))), RTOL_FIELD)


def _with_h3(cfg):
    """``cfg`` with del6 of u, A and lnρ at 5e-3·dx⁵ ('simplified')."""
    h3 = 5e-3 * cfg.grid.dx ** 5
    new = {"density": dict(diffrho_hyper3=h3),
           "magnetic": dict(eta_hyper3=h3)}
    out = []
    for m in cfg.modules:
        if m.name == "viscosity":
            m = dataclasses.replace(m, ivisc=tuple(m.ivisc) + (
                "hyper3-simplified",), nu_hyper3=h3)
        elif m.name in new:
            m = dataclasses.replace(m, **new[m.name])
        out.append(m)
    return cfg.replace(modules=tuple(out))


# the z-ghosted sets with SAFI and the mesh flavour: conv_slab or
# strat_box keyword arguments
ZG_SAFI = {"shear_safi": (conv_slab, dict(Omega=1.0, shear=True)),
           "mag_shear_safi": (conv_slab, dict(magnetic=True, Omega=1.0,
                                              shear=True)),
           "iso_shear_safi": (strat_box, dict(magnetic=False)),
           "iso_mag_shear_safi": (strat_box, {})}


@pytest.mark.parametrize("mesh", (False, True), ids=("plain", "mesh"))
@pytest.mark.parametrize("case", sorted(ZG_SAFI))
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_safi_zghost_kernels_match_plain(cuda, shape, case, mesh):
    """K6s/K7s, K6ms/K7ms, K6si/K7si and K6msi/K7msi with SAFI, their
    instance without del6 or their H3 instance with the mesh weights,
    against their plain versions."""
    make, kw = ZG_SAFI[case]
    cfg = with_safi(make(shape, hyper3=mesh, **kw))
    if mesh:
        cfg = with_mesh(cfg)
    cfg = cfg.replace(time=pt.TimeSpec(itorder=3, tstart=0.37))
    pm = pt.Model(cfg, device=cuda)
    if "ss" in pm.reg.slots:
        _zghost_kernels_match_plain(cuda, cfg)
        return
    first_p, upd_p = fr.zg_plain(pm)
    inp = iso_fg(pm)
    df, dt1m = fr.rhs_zg(pm, *inp)
    df_p, dt1m_p = first_p(pm, *inp)
    torch.testing.assert_close(dt1m, dt1m_p, rtol=RTOL_DT, atol=0.0)
    assert_field_close(df, df_p, "df (K6)")
    coef = torch.stack((pm._alpha[1], pm.rk[1][1] / dt1m_p))
    inp2 = iso_fg(pm, seed=5)
    df2, f2 = fr.rhs_zg_upd(pm, *inp2, df_p.clone(), coef)
    df2_p, f2_p = upd_p(pm, *inp2, df_p.clone(), coef)
    assert_field_close(df2, df2_p, "df (K7)")
    assert_field_close(f2, f2_p, "f (K7)")


@pytest.mark.parametrize("case", ("conv", "mag"))
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES, ids=FLAGSHIP_IDS)
def test_mesh_zghost_kernels_match_plain(cuda, shape, case):
    """K6/K7 and K6m/K7m's H3 instances with the mesh weights."""
    _zghost_kernels_match_plain(cuda, with_mesh(conv_slab(
        shape, magnetic=case == "mag", hyper3=True)))


@pytest.mark.parametrize("case", ("mhd", "hydro", "ent_mhd", "ent_hydro"))
@pytest.mark.parametrize("shape", ((32, 32, 32), (24, 20, 42)),
                         ids=("32^3", "24x20x42"))
def test_mesh_template_instances_match_plain(cuda, shape, case):
    """K1, K2, K3, K3′ and K2L's H3 instances of the four periodic builds
    with the mesh weights and the mesh rate in the CFL."""
    make = {"mhd": pt.configs.flagship, "hydro": forced_hydro,
            "ent_mhd": forced_entropy,
            "ent_hydro": lambda s, **k: forced_entropy(s, magnetic=False,
                                                       **k)}[case]
    _template_instances_match_plain(cuda, make(shape, hyper3="mesh"),
                                    RTOL_FIELD)


@pytest.mark.parametrize("case", ("shear_box", "strat_box", "conv_slab"))
def test_safi_steps_on_card_match_cpu(cuda, case):
    """Three SAFI steps (the shift between substeps on the card) against
    the same steps on the CPU: the shear box with the mesh flavour and the
    mean removal, the stratified MRI box and the sheared conv-slab.  The
    stratified sets start from velocity noise of 1e-1: the shift's
    transform of lnρ's O(1) profile rounds differently in cuFFT and on
    the CPU, and with noise of 1e-2 the u it drives parts by up to 2.6e-5
    of its max (chip_smoke.py, SAFI_UU_NOISE)."""
    if case == "shear_box":
        _steps_match(cuda, shear_box((16, 16, 32), safi=True, hyper3="mesh",
                                     remove_mean_momenta=True), t0=0.37)
    elif case == "strat_box":
        _conv_slab_steps_match(cuda, strat_box((16, 16, 32), safi=True),
                               noise=0.1)
    else:
        _conv_slab_steps_match(cuda, conv_slab((16, 16, 32), Omega=0.5,
                                               shear=True, safi=True),
                               noise=0.1)


def test_mean_removal_flagship_steps_on_card_match_cpu(cuda):
    """The forced flagship with lremove_mean_momenta: K3 without its kick,
    the mean removed, then the kick, on the card against the CPU."""
    _steps_match(cuda, pt.configs.flagship((16, 16, 32),
                                           remove_mean_momenta=True))


@pytest.mark.parametrize("ny", (64, 128, 256))
def test_fourier_shifts_on_card_match_cpu(cuda, ny):
    """The shear-periodic x faces' shift (on a view of a ghosted stack)
    and the SAFI shift on the card against the CPU: cuFFT's C2R read the
    imaginary part of the Nyquist bin from 128 rows up, which parted the
    faces by 1e-2 of their max at 256 (the shifts now hand it a real
    bin)."""
    from pencil_tpu_torch.core.grid import make_grid
    from pencil_tpu_torch.physics.shear import fourier_shift_y
    g = torch.Generator().manual_seed(0)
    fg = torch.randn((8, 14, ny + 6, 16), generator=g)
    slab = fg[..., 0:3, 3:3 + ny, :]
    dy = torch.tensor(0.555)
    want = fourier_shift_y(slab, dy, 1.0)
    got = fourier_shift_y(slab.to(cuda), dy.to(cuda), 1.0).cpu()
    assert_field_close(got, want, "x faces")
    gs = pt.GridSpec(nx=8, ny=ny, nz=16, x0=-0.5, y0=-0.5, z0=-0.5)
    sh = pt.Shear(lshearadvection_as_shift=True)
    a = torch.randn((7, 8, ny, 16), generator=g)
    out = [sh.shift_advection(a.to(dev), make_grid(gs, dev), 1.0,
                              torch.tensor(3e-3, device=dev)).cpu()
           for dev in (cuda, torch.device("cpu"))]
    assert_field_close(out[0], out[1], "SAFI shift")


# Entropy's other conduction and cooling terms on the z-ghosted builds
# with ss: conv_slab keyword arguments of each case; 'K-profile' on the
# base instances, Kramers (clipped) and 'chi-cspeed' on the CHI ones, each
# with Newtonian cooling, uniform heating and cooling and a cooling profile
HEATCOND_CASES = {
    "kprofile": dict(heatcond="K-profile", tau_cool=2.0,
                     cooling_profile="step",
                     entropy=dict(heat_uniform=1e-2, cool_uniform=2e-3)),
    "kramers": dict(heatcond="kramers", cooling_profile="cubic_step",
                    entropy=dict(chimin_kramers=6e-3, chimax_kramers=1.5e-2)),
    "cspeed": dict(chi=4e-3, chi_cspeed=0.5, tau_cool=2.0,
                   cooling_profile="lin-z")}


# the six builds: conv_slab keyword arguments
SS_BUILDS = {"conv_slab": {}, "mag": dict(magnetic=True),
             "shear": dict(Omega=1.0, shear=True),
             "mag_shear": dict(magnetic=True, Omega=1.0, shear=True),
             "shock": dict(shock=True),
             "mag_shock": dict(magnetic=True, shock=True)}


@pytest.mark.parametrize("build", sorted(SS_BUILDS))
@pytest.mark.parametrize("case", sorted(HEATCOND_CASES))
def test_heatcond_kernels_match_plain(cuda, case, build):
    """K6/K7 of each z-ghosted build with ss, with 'K-profile' (the base
    instances, K(z) read from its vector), Kramers and 'chi-cspeed' (the
    CHI instances, their exponential form), against their plain
    versions."""
    _zghost_kernels_match_plain(cuda, conv_slab(
        (32, 32, 32), **SS_BUILDS[build], **HEATCOND_CASES[case]))


@pytest.mark.parametrize("case", ("kramers", "mag_kramers_cooled"))
def test_heatcond_steps_on_card_match_cpu(cuda, case):
    """Two steps of convection with Kramers opacity (K6/K7 chi) and of
    magnetoconvection with Kramers opacity, Newtonian cooling and the
    'cubic_step' profile (K6m/K7m chi) on the card against the CPU, the
    state made on the CPU, velocity noise of 1e-2."""
    kw = dict(heatcond="kramers")
    if case == "mag_kramers_cooled":
        kw.update(magnetic=True, tau_cool=2.0, cooling_profile="cubic_step")
    _steps_match(cuda, conv_slab((32, 32, 32), **kw), nsteps=2,
                 uu_noise=1e-2)


# the z-wall codes, grouped: a bcz override of conv_slab(n, magnetic=True)
# each, its conv_slab keyword arguments and force_bound (the cases of
# tests/test_torch_bc_walls.py, several codes a case)
WALL_FLUX = dict(chi_t=2e-3, chit_prof1=0.5, chit_prof2=1.5, hcondbot=1e-3,
                 hcondtop=2e-3, Fbot=0.02, Ftop=0.01)
WALL_CASES = {
    "der_cop_0_e1": ({"ux": ("der", 0.5, -0.3), "uy": "cop:0",
                      "uz": "e1"}, {}, None),
    "e2_1s_e3": ({"ux": "e2", "uy": "1s", "uz": "e3"}, {}, None),
    "s0d_d1s_n1s": ({"ux": "s0d", "uy": ("d1s", 0.01, -0.02),
                     "uz": ("n1s", 0.1, 0.2)}, {}, None),
    "v_v3_out": ({"ux": "v", "uy": "v3", "uz": "out"}, {}, None),
    "ouf_ubs_nil": ({"ux": "nil", "uy": "ubs", "uz": "ouf"}, {}, None),
    "ism": ({"lnrho": ("ism", 0.9, 0.9), "ss": ("ism", 0.5, 0.5)}, {},
            None),
    "cdz_sT": ({"lnrho": "cdz:StS", "ss": "sT"}, {}, None),
    "c2_ctz": ({"ss": ("c2:ctz", 1.2, 0.0)}, {}, None),
    "cT2_ce": ({"ss": ("cT2:ce", 0.0, 1.1)}, {}, None),
    "hs": ({"lnrho": "a2:hs", "ss": "c1:hs"}, {}, None),
    "div": ({"uz": ("div", 0.1, -0.1)}, {}, None),
    "pot": ({"ax": "pot", "ay": "pwd", "az": "pfe"}, {}, None),
    "c1_aa": ({"ax": "c1", "ay": "nil", "az": "c1"}, {}, None),
    "Fgs_kramers": ({"lnrho": "a2:hs", "ss": "c1:Fgs"},
                    dict(heatcond="kramers"), None),
    "Fgs_Fct": ({"ss": "Fgs:Fct"}, {}, None),
    "g": ({"ux": "g", "ss": "g"}, {}, ("", "cT")),
}


def _wall_fills_match(cuda, name, shape):
    """The 3-axis fill, the chain's (zg_input and the kernels' ghosting)
    and the pinned boundary planes of the case ``name`` on the card
    against the CPU, on one stack made on the CPU: each component within
    1e-6 of its max."""
    from pencil_tpu_torch.parallel.halo import (
        ghosted_from_sheared_z_slabs, ghosted_from_z_slabs)
    over, kw, force = WALL_CASES[name]
    cfg = conv_slab(shape, magnetic=True, bcz=over, **kw, entropy=dict(
        WALL_FLUX, sigmaSBt=pt.configs.fgs_sigma()))
    if force is not None:
        cfg = cfg.replace(force_bound=force)
    cpu = torch.device("cpu")
    models = {dev: pt.Model(cfg, device=dev) for dev in (cuda, cpu)}
    init = models[cpu].init_state(0)["fields"]
    g = torch.Generator().manual_seed(7)
    fa = 1e-2 * torch.randn((8,) + shape, generator=g)
    fa[3:4] += init["lnrho"]
    fa[4:5] += init["ss"]
    if "e3" in name:
        fa[2] += 0.5
    out = []
    for dev, m in models.items():
        x = fa.to(dev)
        body, zlo, zhi = m.zg_input(x.clone())
        chain = (ghosted_from_sheared_z_slabs if m.zg_xy
                 else ghosted_from_z_slabs)(body, zlo, zhi)
        out.append([t.cpu() for t in (m.ghosted(x), chain,
                                      m.bc_writeback(x.clone()))])
    for a, b in zip(*out):
        assert torch.isfinite(a).all()
        for c in range(b.shape[0]):
            err = float((a[c] - b[c]).abs().max())
            assert err <= 1e-6 * max(float(b[c].abs().max()), 1e-30), \
                (name, c, err)


@pytest.mark.parametrize("case", sorted(WALL_CASES))
def test_wall_fills_on_card_match_cpu(cuda, case):
    _wall_fills_match(cuda, case, (32, 32, 32))


@pytest.mark.parametrize("case", ("pot", "c1_aa"))
def test_wall_fft_fills_on_card_match_cpu_at_128_rows(cuda, case):
    """'pot'/'pwd'/'pfe' and 'c1' on A transform whole planes (torch.fft,
    C2C): checked with 128 rows along x and y."""
    _wall_fills_match(cuda, case, (128, 128, 16))


# one set for each layout route of the z-walled chain: the x/y-ghosted
# slabs (a vacuum exterior on K6ms/K7ms at S = 0), the cut of g + 1 planes
# (a black-body top over a hydrostatic density top, K6/K7 chi) and of
# 2g + 1 ('s0d')
WALL_STEPS = {
    "vacuum": dict(magnetic=True, bcz=dict.fromkeys(("ax", "ay", "az"),
                                                     "pot")),
    "radiative": dict(heatcond="kramers", bcz={"lnrho": "a2:hs",
                                               "ss": "c1:Fgs"}),
    "s0d": dict(bcz={"ux": "s0d", "uy": "s0d"})}


@pytest.mark.parametrize("case", sorted(WALL_STEPS))
def test_wall_steps_on_card_match_cpu(cuda, case):
    """Two steps of each layout route on the card against the CPU, the
    state made on the CPU, velocity noise of 1e-2."""
    kw = WALL_STEPS[case]
    if case == "radiative":
        kw = dict(kw, entropy=dict(sigmaSBt=pt.configs.fgs_sigma()))
    _steps_match(cuda, conv_slab((32, 32, 32), **kw), nsteps=2,
                 uu_noise=1e-2)


# ---- Viscosity's other flavours and Density's diffrho (visx) -------------------
def _with_all_flavours(cfg):
    """``cfg`` with every flavour its build takes beside its own:
    'nu-simplified', 'rho-nu-const' and the bulk ζ = 1e-3 in every build,
    'shock-simple' with the shock slot, 'nu-cspeed' on the z-walled builds
    with ss, and diffrho = ν."""
    visc = cfg.module("viscosity")
    add = ("nu-simplified", "rho-nu-const", "rho-nu-const-bulk")
    if cfg.module("shock") is not None:
        add += ("shock-simple",)
    if cfg.module("entropy") is not None and not all(cfg.grid.periodic):
        add += ("nu-cspeed",)
    return pt.configs.with_viscosity(cfg, tuple(visc.ivisc) + add,
                                     zeta=1e-3, diffrho=visc.nu)


VISC_TEMPLATE = {"mhd": lambda s: flagship(s),
                 "hydro": lambda s: forced_hydro(s),
                 "ent_mhd": lambda s: forced_entropy(s),
                 "ent_hydro": lambda s: forced_entropy(s, magnetic=False)}


@pytest.mark.parametrize("case", sorted(VISC_TEMPLATE))
def test_visc_template_instances_match_plain(cuda, case):
    """The four periodic builds' K1-K3, K3′ and K2L with every flavour on
    (visx taken) against their plain versions at 32³."""
    cfg = _with_all_flavours(VISC_TEMPLATE[case]((32, 32, 32)))
    _template_instances_match_plain(
        cuda, cfg, RTOL_FIELD if "ent" in case else 1e-6)


def _aniso_cfg(case):
    cfg = VISC_TEMPLATE[case]((32, 32, 32))
    h3 = 5e-3 * cfg.grid.dx ** 5
    return pt.configs.with_viscosity(
        _with_h3(cfg), ("nu-simplified", "hyper3_nu-const_aniso"), nu=5e-3,
        nu_aniso_hyper3=(h3, h3, h3 / 2))


def test_visc_spilling_instance_raises(cuda):
    """The 4-field hydro build's K1 UPW is built without the flavours'
    terms (it would spill at its 128 registers): its wrapper raises with
    them on, and the gate refuses the configuration."""
    cfg = pt.configs.with_viscosity(with_upwind(forced_hydro((32, 32, 32))),
                                    ("nu-const",), nu=5e-3, diffrho=1e-3)
    assert "K1 UPW" in pt.model.gate_reason(cfg)
    pm = pt.Model(with_upwind(forced_hydro((32, 32, 32))), device=cuda)
    pm.__dict__["_pc_params"] = fr.kernel_params(
        pt.Model(cfg, device="cpu"))
    fa = random_fa((32, 32, 32), cuda, nvar=pm.reg.nvar)
    with pytest.raises(NotImplementedError, match="spill"):
        fr.rhs_first(pm, fa)


@pytest.mark.parametrize("case", ("mhd", "hydro", "ent_mhd", "ent_hydro"))
def test_visc_aniso_h3_instances_match_plain(cuda, case):
    """The H3 instances of the four periodic builds with
    'hyper3_nu-const_aniso' in place of 'hyper3-simplified' (ν₃ⱼ = ν₃,
    ν₃, ν₃/2) and 'nu-simplified' against their plain versions."""
    _template_instances_match_plain(cuda, _aniso_cfg(case), RTOL_FIELD)


VISC_AUX = {"shock": dict(), "shock_hydro_ent": dict(magnetic=False,
                                                       entropy=True),
            "shock_ent": dict(entropy=True)}


@pytest.mark.parametrize("case", sorted(VISC_AUX))
def test_visc_aux_kernels_match_plain(cuda, case):
    """K1s/K5w and two of their layouts with every flavour, 'shock-simple'
    among them, against their plain versions at 32³."""
    _aux_kernels_match_plain(cuda, _with_all_flavours(shock_box(
        (32, 32, 32), **VISC_AUX[case])), 1e-6)


@pytest.mark.parametrize("build", sorted(SS_BUILDS))
def test_visc_zghost_kernels_match_plain(cuda, build):
    """K6/K7 of each z-walled build with ss with every flavour,
    'nu-cspeed' among them, against their plain versions at 32³."""
    _zghost_kernels_match_plain(cuda, _with_all_flavours(conv_slab(
        (32, 32, 32), **SS_BUILDS[build])))


@pytest.mark.parametrize("label", (
    "flagship rho-nu-const", "forced hydro aniso", "shock box bulk",
    "conv-slab rho-nu-const", "magnetoconvection nu-therm",
    "shear box rho-nu-const"))
def test_visc_paths_on_card_match_cpu(cuda, label):
    """Two steps of each path of configs.VISCOSITY_PATHS at 32³ on the
    card against the CPU, the state made on the CPU (velocity noise of
    1e-2 between walls, 0.1 in the shock box; the shear box from
    t = 0.37)."""
    cfg = pt.configs.viscosity_path(label, (32, 32, 32))
    if label.startswith("shear"):
        _steps_match(cuda, cfg, t0=0.37, nsteps=2)
    elif label.startswith("shock"):
        _steps_match(cuda, cfg, nsteps=2, uu_noise=0.1)
    else:
        _steps_match(cuda, cfg, nsteps=2,
                     uu_noise=1e-2 if "conv" in label or "magneto" in label
                     else 0.0)
