"""The isothermal stratified layer (``strat_box``: hydro or MHD, under
constant gravity or, in the shearing box, g_z = −Ω²z) in
pencil_tpu_torch against pencil_tpu: the plain versions of K6i/K7i,
K6mi/K7mi, K6si/K7si and K6msi/K7msi (the z-ghosted builds without ss)
against the zghost Pallas kernels traced for those sets, on the interior
(with Shear the x/y-ghosted) stack and the z-halo slabs cut from the JAX
package's fill, with the shifted x faces for the sheared sets; the port's
Gravity ('const', 'linear-z') and Density(init='isothermal') against
JAX's; the gate, the libraries, the launch names and kernel constants;
'linear-z' on the z-ghosted builds with ss, refused in a periodic box
for the layer profiles; a step that leaves its input alone; a JAX state of each layout through the
converters.  The steps are in tests/test_torch_zghost_iso_steps.py.

The JAX side runs as tests/test_torch_zghost_shear.py runs it: the Pallas
kernels in interpret mode with one tile over the whole domain (PC_TX =
PC_CX = nx; the JAX Gravity module sizes its acceleration from the
global grid, ROADMAP Queue 3), inputs from numpy with a seed, velocity
and vector-potential noise of 1e-2, the sheared sets from t = 0.37.
Bounds, those of tests/test_fused.py: each field within 2e-5 × its max,
the CFL maximum within 1e-6 relative.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.io.snapshot import save_snapshot
from pencil_tpu.parallel.halo import fill_ghosts as j_fill_ghosts
from pencil_tpu_torch.compat.from_jax import (overrides_from_numpy,
                                              snapshot_from_jax)
from pencil_tpu_torch.configs import conv_slab, strat_box
from pencil_tpu_torch.model import fused_gate, fused_mode, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_zghost_mhd import (AA_AMPL, UU_AMPL, assert_field_close,
                                   z_split)
from test_torch_zghost_shear import zg_split

torch.set_num_threads(1)

RTOL_DT = 1e-6
TSTART = 0.37
G = 3
# the four sets: strat_box keyword arguments; each with its library and
# the base of its launch names
CASES = {"iso": dict(magnetic=False, shear=False),
         "iso_mag": dict(shear=False),
         "iso_shear": dict(magnetic=False),
         "iso_mag_shear": {}}
LIBRARY = {case: "fused_rhs_zg_" + case for case in CASES}
NAMES = {case: (f"rhs_zg_{case}", f"rhs_zg_upd_{case}") for case in CASES}
# the kernels' cases: (shape, set, del6 on); the sheared sets have Ω = 1
# and g_z = −z, the others constant gravity
KERNEL_CASES = (((16, 16, 16), "iso", False),
                ((16, 16, 32), "iso_mag", True),
                ((16, 16, 32), "iso_shear", True),
                ((16, 16, 16), "iso_mag_shear", False))
KERNEL_IDS = tuple(f"{'x'.join(map(str, s))}-{c}{'-h3' if h3 else ''}"
                   for s, c, h3 in KERNEL_CASES)


def strat_cfg(pkg, shape, case, hyper3=False, fused=True, **kw):
    """The set ``case`` at ``shape``, the sheared ones from t = TSTART."""
    cfg = strat_box(shape, fused=fused, pkg=pkg, hyper3=hyper3,
                    **dict(CASES[case], **kw))
    if cfg.module("shear") is not None:
        cfg = cfg.replace(time=pkg.TimeSpec(itorder=3, tstart=TSTART))
    return cfg


def noisy_fields(pm, rng):
    """(nvar, nx, ny, nz) numpy: the isothermal lnρ with noise, noisy
    velocities and, with Magnetic, a noisy vector potential."""
    lnrho = pm.init_state(0)["fields"]["lnrho"].numpy()
    shape = pm.cfg.grid.shape
    parts = [UU_AMPL * rng.standard_normal((3,) + shape),
             lnrho[None] + 1e-2 * rng.standard_normal(shape)]
    if "aa" in pm.reg.slots:
        parts.append(AA_AMPL * rng.standard_normal((3,) + shape))
    return np.concatenate(parts).astype(np.float32)


def jax_fill(jm, fa):
    """The JAX 3-axis fill of ``fa`` (numpy), with the x faces shifted by
    deltay at TSTART for a sheared set, as numpy."""
    shear = jm.cfg.module("shear")
    sdy = None if shear is None else shear.deltay(
        jnp.float32(TSTART), jm.cfg.grid.Lx, jm.cfg.grid.Ly)
    return np.asarray(j_fill_ghosts(
        jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg, jm.grid, jm.cfg,
        jm.eos, shear_dy=sdy))


def kernel_input(pm, fg):
    """(body, zlo, zhi) of a 3-axis ghosted stack as ``pm``'s z-ghosted
    kernels take them."""
    return zg_split(fg) if pm.shear is not None else z_split(fg)


@pytest.fixture(scope="module", params=KERNEL_CASES, ids=KERNEL_IDS)
def kernels(request):
    """K6 and K7 of the JAX package (interpret mode) traced for one set,
    each on a noisy stack filled by JAX, every result kept as numpy."""
    shape, case, h3 = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(shape[0]))
        mp.setenv("PC_CX", str(shape[0]))
        jm = pj.Model(strat_cfg(pj, shape, case, h3))
        pm = pt.Model(strat_cfg(pt, shape, case, h3), device="cpu")
        fg = jax_fill(jm, noisy_fields(pm, np.random.default_rng(5)))
        z = jm.grid.z
        df1, dt1 = jm._fused_rhs(shape, False, False, True)(jnp.asarray(fg), z)
        alpha, beta, _ = jm.rk
        dt = 1.0 / jnp.max(dt1)
        fg2 = jax_fill(jm, noisy_fields(pm, np.random.default_rng(6)))
        df2, f2, _ = jm._fused_rhs(shape, True, False, True)(
            jnp.asarray(fg2), z, df1, alpha[1], beta[1] * dt)
    return dict(pm=pm, case=case, h3=h3, fg=fg, fg2=fg2,
                df1=np.asarray(df1), dt1max=float(jnp.max(dt1)),
                dt=np.float32(dt), df2=np.asarray(df2), f2=np.asarray(f2))


def test_rhs_zg_iso_matches_pallas(kernels):
    """K6i's (K6mi's, K6si's, K6msi's) plain version: df with g_z(z) on
    u_z and, sheared, the Shear terms; the max 1/dt with the constant
    diffusive rate (and del6's), the Alfvén speed with Magnetic."""
    pm = kernels["pm"]
    first = fr.zg_kernels(pm)[0]
    assert first == NAMES[kernels["case"]][0] + ("_h3" if kernels["h3"]
                                                 else "")
    df, dt1m = fr.rhs_zg(pm, *kernel_input(pm, kernels["fg"]))
    assert dt1m.ndim == 0
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    assert df.shape == (pm.reg.nvar,) + pm.cfg.grid.shape
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_rhs_zg_iso_upd_matches_pallas(kernels):
    """K7i's (K7mi's, K7si's, K7msi's) plain version: df (written over
    df_prev) and f."""
    pm = kernels["pm"]
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = fr.rhs_zg_upd(pm, *kernel_input(pm, kernels["fg2"]), df_prev,
                          coef)
    assert df is df_prev
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


@pytest.mark.parametrize("profile", ("const", "linear-z", "linear"))
def test_gravity_matches_jax(profile):
    """The port's Gravity: the acceleration (0, 0, g_z) and the potential
    Φ against JAX's on the same grid, bit for bit; g_z(z) as the
    z-ghosted builds read it is the acceleration's u_z at every z."""
    shape = (4, 4, 12)
    kw = dict(gravz_profile=profile, gravz=-0.81)
    cfg = strat_box(shape, magnetic=False, shear=False)
    jm = pj.Model(strat_box(shape, pkg=pj, magnetic=False, shear=False,
                            fused=False))
    pm = pt.Model(cfg, device="cpu")
    jg, pg = pj.Gravity(**kw), pt.Gravity(**kw)
    want = np.asarray(jg.gvec(SimpleNamespace(grid=jm.grid, cfg=jm.cfg)))
    got = pg.gvec(SimpleNamespace(grid=pm.grid,
                                  lnrho=lambda: torch.zeros(shape)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pg.gz(pm.grid.z).numpy(),
                                  want[2, 0, 0])
    np.testing.assert_array_equal(
        pg.potential_field(pm.grid, cfg.grid).numpy(),
        np.asarray(jg.potential_field(jm.grid, jm.cfg.grid)))


@pytest.mark.parametrize("case", CASES)
def test_isothermal_density_matches_jax(case):
    """Density(init='isothermal'): lnρ = lnρ0 − γΦ/cs0², the JAX init bit
    for bit (−z under constant gravity, −z²/2 under 'linear-z'); with an
    entropy field (strat_box(entropy=True)) also JAX's ss, its '+ss' term
    −(cp − cv)(lnρ − lnρ0) added to Entropy's zeros, bit for bit: T = T0
    everywhere."""
    shape = (4, 4, 12)
    js = pj.Model(strat_cfg(pj, shape, case, fused=False)).init_state(0)
    pm = pt.Model(strat_cfg(pt, shape, case), device="cpu")
    got = pm.init_state(0)["fields"]["lnrho"].numpy()
    np.testing.assert_array_equal(got, np.asarray(js["fields"]["lnrho"]))
    z = pm.grid.z.numpy().astype(np.float64)
    want = -0.5 * z ** 2 if "shear" in case else -z
    np.testing.assert_allclose(got[0, 0], want, atol=1e-6)
    kw = dict(CASES[case], entropy=True)
    js = pj.Model(strat_box(shape, pkg=pj, fused=False, **kw)).init_state(0)
    pm = pt.Model(strat_box(shape, **kw), device="cpu")
    fields = pm.init_state(0)["fields"]
    for k in ("lnrho", "ss"):
        np.testing.assert_array_equal(fields[k].numpy(),
                                      np.asarray(js["fields"][k]), k)
    eos = pm.eos
    lnTT = eos.gamma / eos.cp * fields["ss"] + (eos.gamma - 1.0) * (
        fields["lnrho"] - eos.lnrho0)
    assert float(lnTT.abs().max()) < 1e-6
    assert float(fields["ss"].abs().max()) > 0.1


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("extra", ({}, dict(hyper3=True),
                                   dict(forcing=0.05)),
                         ids=("plain", "h3", "forced"))
def test_gate_takes_the_isothermal_builds(case, extra):
    """Each set, also with del6 and forced, runs the zghost chain on the
    card and on the CPU, on its build without ss, under its launch names
    (with _h3 for del6, never _chi), with the isothermal kernel constants:
    cs0², no conduction, heating or layer terms, max(ν, η) as the CFL's
    constant diffusivity, and sheared Ω and S = −qΩ; the build reads g_z
    of the port's Gravity."""
    cfg = strat_cfg(pt, 8, case, **extra)
    assert gate_reason(cfg) is None
    assert fused_mode(cfg) == ("zghost", None)
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    lib = fr.zg_library(pm)
    assert lib == LIBRARY[case]
    assert fr.ZG_KERNELS[lib] == NAMES[case]
    sfx = "_h3" if extra.get("hyper3") else ""
    assert fr.zg_kernels(pm) == tuple(k + sfx for k in NAMES[case])
    assert lib not in fr.ZG_CHI_LIBRARIES
    assert not any(k.startswith(NAMES[case][0] + "_chi")
                   or k.startswith(NAMES[case][1] + "_chi")
                   for k in fr.LAUNCHES)
    assert all(k in fr.LAUNCHES for k in fr.zg_kernels(pm))
    assert all(k in fr.library_instances(lib)
               for k in fr.zg_kernels(pm))
    assert not any("_chi" in k for k in fr.library_instances(lib))
    p = fr.kernel_params(pm)
    f32 = np.float32
    mag = "mag" in case
    eta = 5e-3 if mag else 0.0
    assert p.isothermal == 1 and p.cs20 == f32(1.0) and p.gm1 == 0.0
    assert (p.two_nu, p.eta_heat, p.hcond0, p.cpchi, p.cool, p.cs2c,
            p.heat_norm) == (0.0,) * 7
    assert p.maxdif == f32(max(5e-3, eta)) and p.eta == f32(eta)
    shear = "shear" in case
    assert list(p.om) == [0.0, 0.0, 1.0 if shear else 0.0]
    assert p.S == f32(-1.5 if shear else 0.0)
    *unread, gz = fr.zg_profiles(pm)
    assert unread == [None, None]
    assert gz is fr.gravity_vector(pm)
    z = pm.grid.z
    want = -1.0 * z if shear else torch.full_like(z, -1.0)
    assert torch.equal(gz, want)


def test_entropy_builds_refuse_linear_z():
    """The z-ghosted builds with ss read g_z(z) as the others do: each
    conv-slab set (with Magnetic, with Shear, with both) under 'linear-z'
    runs the zghost chain; in a fully periodic box the same set is
    refused on the card for its layer profiles (an option, before any
    admission: no periodic build has them) and runs eagerly on the CPU."""
    for kw in ({}, dict(magnetic=True), dict(Omega=0.5, shear=True),
               dict(magnetic=True, Omega=0.5, shear=True)):
        base = conv_slab(8, **kw)
        cfg = base.replace(modules=tuple(
            pt.Gravity(gravz_profile="linear-z", gravz=-1.0)
            if m.name == "gravity" else m for m in base.modules))
        assert fused_mode(cfg) == ("zghost", None)
        assert fused_mode(base) == ("zghost", None)
        boxed = cfg.replace(grid=pt.GridSpec(nx=8, ny=8, nz=8), bcz=())
        reason = gate_reason(boxed)
        assert reason is not None and reason.startswith("options "), reason
        assert "cool/luminosity" in reason
        with pytest.raises(NotImplementedError, match="cool/luminosity"):
            pt.Model(boxed, device="cuda")
        assert pt.Model(boxed, device="cpu").mode is None


def test_unported_gravity_stays_refused():
    """Every profile that is not a function of z alone still raises as the
    module is built: gravx, an x profile, the central and the radial
    potentials, and an unknown name."""
    for kw in (dict(gravx=1.0), dict(gravx_profile="kepler"),
               dict(gravz_profile="central"), dict(ipotential="newton"),
               dict(gravz_profile="no-such-profile")):
        with pytest.raises(NotImplementedError):
            pt.Gravity(**kw)


def test_strat_box_values():
    """strat_box in both packages: the grid [−2, 2]³ with z walls, γ = 1,
    the gravity and shear of each set, the bcz of its fields; shear
    without Ω raises."""
    for pkg in (pt, pj):
        cfg = strat_box(8, pkg=pkg)
        gs = cfg.grid
        assert (gs.x0, gs.y0, gs.z0, gs.Lx, gs.Ly, gs.Lz) == (
            -2.0, -2.0, -2.0, 4.0, 4.0, 4.0)
        assert tuple(gs.periodic) == (True, True, False)
        assert cfg.module("eos").gamma == 1.0
        grav = cfg.module("gravity")
        assert (grav.gravz_profile, grav.gravz) == ("linear-z", -1.0)
        assert cfg.module("shear").qshear == 1.5
        assert [(bc.comp, bc.low) for bc in cfg.bcz] == [
            ("ux", "s"), ("uy", "s"), ("uz", "a"), ("lnrho", "a2"),
            ("ax", "a"), ("ay", "a"), ("az", "s")]
        flat = strat_box(8, pkg=pkg, shear=False, magnetic=False,
                         forcing=0.05)
        assert (flat.module("gravity").gravz_profile,
                flat.module("gravity").gravz) == ("const", -1.0)
        assert flat.module("hydro").Omega == 0.0
        assert flat.module("forcing").force == 0.05
        assert len(flat.bcz) == 4
        with pytest.raises(ValueError):
            strat_box(8, pkg=pkg, Omega=0.0)


@pytest.mark.parametrize("case", ("iso_mag", "iso_mag_shear"))
def test_step_leaves_its_input_alone(case):
    """A step on a packed stack whose walls are not pinned leaves that
    stack as it was, and gives the step of the same fields unpacked; u_z,
    A_x and A_y stay 0 on the walls, all finite."""
    pm = pt.Model(strat_cfg(pt, (8, 8, 16), case), device="cpu")
    s0 = pm.init_state(4)
    fa = torch.tensor(noisy_fields(pm, np.random.default_rng(9)))
    before = fa.clone()
    packed = pm.make_step()({"_fa": fa, "t": s0["t"], "dt": s0["dt"],
                             "it": s0["it"]})
    assert torch.equal(fa, before)
    unpacked = pm.make_step()(dict(s0, fields=pm.reg.unstack(before)))
    out = packed["_fa"]
    assert torch.equal(out, pm.reg.stack(unpacked["fields"]))
    assert bool(torch.isfinite(out).all())
    for c in (2, 4, 5):
        assert bool((out[c][..., [0, -1]] == 0).all()), c


@pytest.mark.parametrize("case", CASES)
def test_jax_state_converts(case, tmp_path):
    """A JAX state of each layout crosses as numpy through
    overrides_from_numpy, and its var.npz through snapshot_from_jax, and
    starts the port's state bit for bit, t included; it steps on."""
    jm = pj.Model(strat_cfg(pj, 8, case, fused=False))
    pm = pt.Model(strat_cfg(pt, 8, case), device="cpu")
    js = jm.init_state(4)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    over = overrides_from_numpy(fields, pm.reg)
    assert list(over) == ["uu", "lnrho"] + (["aa"] if "mag" in case else [])
    save_snapshot(tmp_path / "var.npz", js)
    snap = snapshot_from_jax(tmp_path / "var.npz", pm)
    for k, v in fields.items():
        np.testing.assert_array_equal(snap["fields"][k].numpy(), v, k)
    assert float(snap["t"]) == float(js["t"])
    out = pm.make_step()(snap)
    assert all(bool(torch.isfinite(v).all()) for v in out["fields"].values())
