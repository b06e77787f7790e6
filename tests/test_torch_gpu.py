"""The CUDA kernels of pencil_tpu_torch (K1-K3, K3′, K2L and K8 of the
flagship, their hydro builds K1h-K3h, K3′h, K2Lh, their entropy builds
K1e-K2Le and K1he-K2Lhe, K6/K7 of stratified
convection, K4/K5 of the shearing box, K1s/K5w of the shocked periodic
box) against their plain PyTorch versions on the card, and steps on the
card against the same steps on the CPU, and the run loop's restart on
the card.
Marked ``gpu``: they skip where there is no CUDA device.  On a machine
with one, run them with

    python -m pytest --noconftest tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py imports JAX).  This file
imports no JAX, so it also runs where JAX is not installed.
Bounds: each field within 2e-5 × its max, the CFL maximum within 1e-6
relative (the bounds of tests/test_fused.py:75-84).
"""

import pytest
import torch

import pencil_tpu_torch as pt
from pencil_tpu_torch.configs import (conv_slab, forced_entropy,
                                     forced_hydro, shear_box, shock_box)
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


def test_dt1_buffer_matches_the_grid(cuda):
    """K1 writes one CFL maximum per block of its launch grid, which
    pc_tile_shape's (MX, TY, TZ) sizes: at nx = 80 (two x segments, the
    second 16 planes), every slot is written and nothing past them."""
    import ctypes
    import math
    from pencil_tpu_torch.ops import _build
    shape = (80, 16, 32)
    pm = pt.Model(flagship(shape), device=cuda)
    fa = random_fa(shape, cuda)
    tile = (ctypes.c_int * 3)()
    _build.load().pc_tile_shape(ctypes.addressof(tile))
    n = fr._nblocks(shape)
    assert n == math.prod(-(-s // t) for s, t in zip(shape, tile))
    assert shape[0] % tile[0] != 0
    blk = torch.full((n + 1,), float("nan"), device=cuda)
    df = torch.empty_like(fa)
    p = fr.kernel_params(pm)
    stream = torch.cuda.current_stream().cuda_stream
    assert _build.load().pc_rhs_first(
        ctypes.addressof(p), fa.data_ptr(), df.data_ptr(), blk.data_ptr(),
        stream) == 0
    torch.cuda.synchronize()
    assert bool(torch.isfinite(blk[:n]).all()) and bool((blk[:n] > 0).all())
    assert math.isnan(float(blk[n]))
    torch.testing.assert_close(blk[:n].max(), fr.rhs_first_plain(pm, fa)[1],
                               rtol=RTOL_DT, atol=0.0)


def _steps_match(cuda, cfg, t0=None, nsteps=3):
    """nsteps on the card against the same steps on the CPU from the same
    fields and forcing draws."""
    fields = pt.Model(cfg, device="cpu").init_state(5)["fields"]
    g = torch.Generator().manual_seed(9)
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
    pm = pt.Model(make_cfg(shape), device=cuda)
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


def test_forced_shear_box_steps_on_card_match_cpu(cuda):
    """Three forced zroll steps (K4/K5, the kick after the step) from
    t = 0.37 against the CPU."""
    cfg = shear_box((16, 16, 32))
    _steps_match(cuda, cfg.replace(modules=cfg.modules + (
        pt.Forcing(force=0.07, kf=3.0),)), t0=0.37)


def stratified_fg(pm, seed=4):
    """A z-ghosted conv-slab stack on the card: the piecew-poly profiles
    with noise."""
    g = torch.Generator(pm.device).manual_seed(seed)
    f = pm.init_state(0)["fields"]
    shape = pm.cfg.grid.shape
    fa = torch.cat([1e-2 * torch.randn((3,) + shape, generator=g,
                                       device=pm.device),
                    (f["lnrho"] + 1e-2 * torch.randn(
                        shape, generator=g, device=pm.device))[None],
                    (f["ss"] + 1e-2 * torch.randn(
                        shape, generator=g, device=pm.device))[None]])
    return pm.ghosted(fa)


@pytest.mark.parametrize("shape", ((32, 32, 32), (16, 24, 40)),
                         ids=("32^3", "16x24x40"))
def test_zghost_kernels_match_plain(cuda, shape):
    """K6 and K7 against their plain versions; the second shape is not a
    multiple of the tile."""
    pm = pt.Model(conv_slab(shape), device=cuda)
    fg = stratified_fg(pm)
    fr.reset_launches()
    df, dt1m = fr.rhs_zg(pm, fg)
    df_p, dt1m_p = fr.rhs_zg_plain(pm, fg)
    torch.testing.assert_close(dt1m, dt1m_p, rtol=RTOL_DT, atol=0.0)
    assert_field_close(df, df_p, "df (K6)")
    alpha, beta, _ = pm.rk
    coef = torch.stack((pm._alpha[1], beta[1] / dt1m_p))
    fg2 = stratified_fg(pm, seed=5)
    df2, f2 = fr.rhs_zg_upd(pm, fg2, df_p.clone(), coef)
    df2_p, f2_p = fr.rhs_zg_upd_plain(pm, fg2, df_p.clone(), coef)
    torch.cuda.synchronize()
    assert_field_close(df2, df2_p, "df (K7)")
    assert_field_close(f2, f2_p, "f (K7)")
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0), rhs_zg=1,
                               rhs_zg_upd=1)


def test_conv_slab_steps_on_card_match_cpu(cuda):
    """Three zghost steps through K6/K7 against the same steps on the
    CPU (plain versions) from the same fields.  The velocity noise is
    1e-2, not the configuration's 1e-3: a velocity that small is the
    residual of the O(1) hydrostatic balance and sits below its float32
    floor (see tests/test_torch_zghost.py, UU_AMPL)."""
    shape = (16, 16, 32)
    fields = dict(pt.Model(conv_slab(shape),
                           device="cpu").init_state(5)["fields"])
    g = torch.Generator().manual_seed(5)
    fields["uu"] = 1e-2 * torch.randn((3,) + shape, generator=g)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = pt.Model(conv_slab(shape), device=dev)
        s = model.make_multi_step(3)(model.init_state(5, overrides=fields))
        out[dev.type] = s
    torch.testing.assert_close(out["cuda"]["dt"].cpu(), out["cpu"]["dt"],
                               rtol=RTOL_DT, atol=0.0)
    for k, ref in out["cpu"]["fields"].items():
        a = out["cuda"]["fields"][k].cpu()
        assert_field_close(a[None] if a.ndim == 3 else a,
                           ref[None] if ref.ndim == 3 else ref, k)


def sheared_fg(pm, seed=4):
    """An x/y-ghosted shear-box stack on the card at t = 0.37: noisy
    fields and a positive shock slot, the x faces shifted by deltay."""
    g = torch.Generator(pm.device).manual_seed(seed)
    shape = pm.cfg.grid.shape
    amp = torch.tensor([1e-2] * 4 + [1e-4] * 3, device=pm.device)
    fa = amp[:, None, None, None] * torch.randn(
        (7,) + shape, generator=g, device=pm.device)
    shock = 1e-3 * torch.rand(shape, generator=g, device=pm.device)
    sdy = pm.deltay(torch.tensor(0.37, device=pm.device))
    return pm.ghosted(torch.cat([fa, shock[None]]), (0, 1), sdy)


@pytest.mark.parametrize("shape", ((64, 64, 64), (32, 64, 128),
                                   (16, 24, 40)),
                         ids=("64^3", "32x64x128", "16x24x40"))
def test_zroll_kernels_match_plain(cuda, shape):
    """K4 and K5 against their plain versions; the last shape is not a
    multiple of the tile."""
    pm = pt.Model(shear_box(shape), device=cuda)
    fg = sheared_fg(pm)
    fr.reset_launches()
    df, dt1m = fr.rhs_zroll(pm, fg)
    df_p, dt1m_p = fr.rhs_zroll_plain(pm, fg)
    torch.testing.assert_close(dt1m, dt1m_p, rtol=RTOL_DT, atol=0.0)
    assert_field_close(df, df_p, "df (K4)")
    alpha, beta, _ = pm.rk
    coef = torch.stack((pm._alpha[1], beta[1] / dt1m_p))
    fg2 = sheared_fg(pm, seed=5)
    df2, f2 = fr.rhs_zroll_upd(pm, fg2, df_p.clone(), coef)
    df2_p, f2_p = fr.rhs_zroll_upd_plain(pm, fg2, df_p.clone(), coef)
    torch.cuda.synchronize()
    assert_field_close(df2, df2_p, "df (K5)")
    assert_field_close(f2, f2_p, "f (K5)")
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0), rhs_zroll=1,
                               rhs_zroll_upd=1)


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
    """A noisy shock-box state on the card, urms ≈ 1, its shock slot built
    by the pre-pass (positive, so the shock viscosity is live)."""
    g = torch.Generator(pm.device).manual_seed(seed)
    shape = pm.cfg.grid.shape
    amp = torch.tensor([3 ** -0.5] * 3 + [5e-2] + [1e-2] * 3 + [0.0],
                       device=pm.device)
    fa = amp[:, None, None, None] * torch.randn(
        (8,) + shape, generator=g, device=pm.device)
    return pm._refresh_aux_fa(fa)


@pytest.mark.parametrize("shape", ((64, 64, 64), (32, 64, 128),
                                   (16, 24, 40)),
                         ids=("64^3", "32x64x128", "16x24x40"))
def test_shock_kernels_match_plain(cuda, shape):
    """K1s and K5w against their plain versions; the last shape is not a
    multiple of the tile."""
    pm = pt.Model(shock_box(shape), device=cuda)
    fa = shocked_fa(pm)
    assert float(fa[7].max()) > 0.0
    fr.reset_launches()
    df, dt1m = fr.rhs_wrap_shock(pm, fa)
    df_p, dt1m_p = fr.rhs_wrap_shock_plain(pm, fa)
    torch.testing.assert_close(dt1m, dt1m_p, rtol=RTOL_DT, atol=0.0)
    assert_field_close(df, df_p, "df (K1s)")
    coef = torch.stack((pm._alpha[1], pm.rk[1][1] / dt1m_p))
    fa2 = shocked_fa(pm, seed=5)
    df2, f2 = fr.rhs_wrap_shock_upd(pm, fa2, df_p.clone(), coef)
    df2_p, f2_p = fr.rhs_wrap_shock_upd_plain(pm, fa2, df_p.clone(), coef)
    torch.cuda.synchronize()
    assert_field_close(df2, df2_p, "df (K5w)")
    assert_field_close(f2, f2_p, "f (K5w)")
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               rhs_wrap_shock=1, rhs_wrap_shock_upd=1)


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


@pytest.mark.parametrize("which", ("flagship", "rk2", "rk4", "conv_slab",
                                   "shear_box", "shock_box", "hydro",
                                   "hydro_rk2", "hydro_rk4", "ent_mhd",
                                   "ent_mhd_rk2", "ent_mhd_rk4",
                                   "ent_hydro", "ent_hydro_rk2",
                                   "ent_hydro_rk4"))
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
           "shear_box": shear_box(32), "shock_box": shock_box(32),
           "hydro": forced_hydro(32),
           "hydro_rk2": forced_hydro(32).replace(time=pt.TimeSpec(itorder=2)),
           "hydro_rk4": forced_hydro(32).replace(
               time=pt.TimeSpec(itorder=4))}
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
