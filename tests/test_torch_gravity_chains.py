"""Gravity on every chain in pencil_tpu_torch against pencil_tpu, kernel by
kernel: the port's Gravity (every z profile: 'const' with zinfty, 'zero',
'linear-z', 'sin-z', 'Ferriere' at the default and at cgs-like units) and
Density(init='isothermal') with an entropy field against JAX's; the plain
versions of the four z-ghosted builds with ss (K6/K7, K6m/K7m, K6s/K7s,
K6ms/K7ms) under 'linear-z' and 'sin-z' and of one zroll (K4n) and one
wrap_aux (K1sh) build under gravity, against the Pallas kernels traced
for the same sets; the gate's admissions, its refusal of the layer
profiles in a periodic box and of the profiles that are not z-only; the
launch names; a JAX state of each new layout through the converters.
The periodic builds (K1, K2, K3, K3′, K2L) under gravity are in
tests/test_torch_gravity_wrap_kernels.py (MHD, hydro) and
tests/test_torch_gravity_ent_kernels.py (with ss), the steps in
tests/test_torch_gravity_chains_steps.py.

The JAX side runs the Pallas kernels in interpret mode with one tile over
the whole domain (PC_TX = PC_CX = nx: the JAX Gravity module sizes its
acceleration from the global grid, ROADMAP Queue 3); inputs are numpy
noise from a seed, the sheared sets from t = 0.37.  Bounds, those of
tests/test_fused.py: each field within 2e-5 × its max, the CFL maximum
within 1e-6 relative; the modules bit for bit (sin within 1 ulp).
"""
import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.io.snapshot import save_snapshot
from pencil_tpu_torch.compat.from_jax import (overrides_from_numpy,
                                              snapshot_from_jax)
from pencil_tpu_torch.configs import (conv_slab, forced_entropy,
                                      shear_box, shock_box,
                                      strat_box)
from pencil_tpu_torch.model import fused_gate, fused_mode, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_aux_entropy import deltas, j_ghosted
from test_torch_zghost_iso import jax_fill, kernel_input
from test_torch_zghost_mhd import assert_field_close, noisy_fields

torch.set_num_threads(1)

RTOL_DT = 1e-6
TSTART = 0.37
# each profile's Gravity keyword arguments, κ of 'sin-z' one period over
# the box in z
PROFILES = {"const": dict(gravz_profile="const", gravz=-1.0),
            "linear-z": dict(gravz_profile="linear-z", gravz=-1.0),
            "sin-z": dict(gravz_profile="sin-z", gravz=-1.0)}


def with_gravity(pkg, cfg, profile):
    """``cfg`` of package ``pkg`` with Gravity of ``profile`` in place of
    its own, or added (before Forcing): g_z = −1, −z or −sin(2πz/Lz)."""
    kw = dict(PROFILES[profile])
    if profile == "sin-z":
        kw["kappa_z"] = 2.0 * math.pi / cfg.grid.Lz
    rest = [m for m in cfg.modules if m.name not in ("gravity", "forcing")]
    tail = tuple(m for m in cfg.modules if m.name == "forcing")
    return cfg.replace(modules=tuple(rest) + (pkg.Gravity(**kw),) + tail)


def sheared(pkg, cfg):
    return cfg.replace(time=pkg.TimeSpec(itorder=3, tstart=TSTART)) \
        if cfg.module("shear") is not None else cfg


# ---- the modules -------------------------------------------------------------
MODULES = {"const-zinfty": dict(gravz_profile="const", gravz=-0.81,
                                zinfty=0.3),
           "zero": dict(gravz_profile="zero"),
           "linear-z": dict(gravz_profile="linear-z", gravz=-0.81),
           "linear": dict(gravz_profile="linear", gravz=-0.81),
           "sin-z": dict(gravz_profile="sin-z", gravz=-0.7,
                         kappa_z=math.pi / 2.0),
           "Ferriere": dict(gravz_profile="Ferriere"),
           "Ferriere-cgs": dict(gravz_profile="Ferriere",
                                unit_length=3.086e21)}


@pytest.mark.parametrize("name", MODULES)
def test_gravity_matches_jax(name):
    """The acceleration (0, 0, g_z), g_z(z) as the kernels read it and the
    potential Φ against JAX's on the same grid: bit for bit, sin within 1
    ulp.  'Ferriere' at the default units: g_B² rounds to inf in f32 and
    the disc's term is 0, as in JAX; at cgs-like units both terms act."""
    shape = (4, 4, 12)
    jm = pj.Model(strat_box(shape, pkg=pj, magnetic=False, shear=False,
                            fused=False))
    pm = pt.Model(strat_box(shape, magnetic=False, shear=False),
                  device="cpu")
    jg, pg = pj.Gravity(**MODULES[name]), pt.Gravity(**MODULES[name])
    want = np.asarray(jg.gvec(SimpleNamespace(grid=jm.grid, cfg=jm.cfg)))
    got = pg.gvec(SimpleNamespace(grid=pm.grid,
                                  lnrho=lambda: torch.zeros(shape))).numpy()
    gz = pg.gz(pm.grid.z).numpy()
    ulp = 1 if "sin" in name else 0
    for a in (got[2], np.broadcast_to(gz, got[2].shape)):
        np.testing.assert_array_max_ulp(a, want[2], maxulp=ulp)
    np.testing.assert_array_equal(got[:2], want[:2])
    np.testing.assert_array_max_ulp(
        pg.potential_field(pm.grid, pm.cfg.grid).numpy(),
        np.asarray(jg.potential_field(jm.grid, jm.cfg.grid)), maxulp=ulp)
    if name == "Ferriere":
        assert np.abs(gz).max() < 1e-20
    if name == "Ferriere-cgs":
        assert np.abs(gz).max() > 1e12


@pytest.mark.parametrize("kw", (dict(), dict(magnetic=False),
                                dict(periodic=True, shear=False)),
                         ids=("mhd", "hydro", "periodic"))
def test_isothermal_density_with_ss_matches_jax(kw):
    """strat_box(entropy=True): lnρ and JAX's '+ss', ss = −(cp − cv)(lnρ
    − lnρ0) added to Entropy's zeros, bit for bit; T = T0 everywhere; the
    periodic box's lnρ in 'sin-z''s Φ."""
    shape = (4, 4, 12)
    js = pj.Model(strat_box(shape, pkg=pj, fused=False, entropy=True,
                            **kw)).init_state(0)
    pm = pt.Model(strat_box(shape, entropy=True, **kw), device="cpu")
    fields = pm.init_state(0)["fields"]
    for k in ("lnrho", "ss"):
        np.testing.assert_array_equal(fields[k].numpy(),
                                      np.asarray(js["fields"][k]), k)
    eos = pm.eos
    lnTT = eos.gamma / eos.cp * fields["ss"] + (eos.gamma - 1.0) * (
        fields["lnrho"] - eos.lnrho0)
    assert float(lnTT.abs().max()) < 1e-6
    # an entropy init that assigns ss takes no '+ss'
    cfg = strat_box(shape, entropy=True, **kw)
    own = cfg.replace(modules=tuple(
        pt.Entropy(iheatcond=("chi-const",), chi=5e-3, init="piecew-poly")
        if m.name == "entropy" else m for m in cfg.modules))
    assert "+ss" not in pt.Density(init="isothermal").init_fields(
        pm.grid, cfg.grid, None, cfg=own)


def test_strat_box_values():
    """The new keyword arguments in both packages: entropy=True takes γ =
    5/3, cs0 = cp = 1, chi-const with χ = ν = 5e-3 and the wall BC 'a2' on
    ss; periodic=True a periodic z without bcz under 'sin-z' with κ =
    π/2; shear with periodic raises."""
    for pkg in (pt, pj):
        ent = strat_box(8, pkg=pkg, entropy=True)
        eos, e = ent.module("eos"), ent.module("entropy")
        assert (eos.gamma, eos.cs0, eos.cp) == (5.0 / 3.0, 1.0, 1.0)
        assert (e.iheatcond, e.chi) == (("chi-const",), 5e-3)
        assert e.chi == ent.module("viscosity").nu
        assert [(bc.comp, bc.low, bc.high) for bc in ent.bcz][4] == (
            "ss", "a2", "a2")
        assert ent.module("gravity").gravz_profile == "linear-z"
        per = strat_box(8, pkg=pkg, periodic=True, shear=False,
                        forcing=0.05)
        assert tuple(per.grid.periodic) == (True, True, True)
        assert per.bcz == ()
        g = per.module("gravity")
        assert (g.gravz_profile, g.gravz, g.kappa_z) == ("sin-z", -1.0,
                                                         math.pi / 2.0)
        assert per.module("shear") is None and per.module("entropy") is None
        assert strat_box(8, pkg=pkg) == strat_box(
            8, pkg=pkg, entropy=False, periodic=False)
        with pytest.raises(ValueError):
            strat_box(8, pkg=pkg, periodic=True)


# ---- the z-ghosted builds with ss under g_z(z) -------------------------------
ZG = {"slab": {}, "mag": dict(magnetic=True),
      "shear": dict(Omega=1.0, shear=True),
      "mag_shear": dict(magnetic=True, Omega=1.0, shear=True)}
ZG_CASES = [(case, prof) for case in ZG for prof in ("linear-z", "sin-z")]


@pytest.fixture(scope="module", params=ZG_CASES,
                ids=[f"{c}-{p}" for c, p in ZG_CASES])
def zg_kernels(request):
    """K6 and K7 of the JAX package (interpret mode) traced for a conv-slab
    set under the profile, at 8×8×16, each on a noisy stack filled by
    JAX (with Shear the x faces shifted at t = 0.37); numpy results."""
    case, prof = request.param
    shape = (8, 8, 16)

    def cfg(pkg):
        return sheared(pkg, with_gravity(pkg, conv_slab(shape, pkg=pkg,
                                                        **ZG[case]), prof))

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(shape[0]))
        mp.setenv("PC_CX", str(shape[0]))
        jm = pj.Model(cfg(pj))
        pm = pt.Model(cfg(pt), device="cpu")
        fg = jax_fill(jm, noisy_fields(pm, np.random.default_rng(5)))
        z = jm.grid.z
        df1, dt1 = jm._fused_rhs(shape, False, False, True)(jnp.asarray(fg), z)
        alpha, beta, _ = jm.rk
        dt = 1.0 / jnp.max(dt1)
        fg2 = jax_fill(jm, noisy_fields(pm, np.random.default_rng(6)))
        df2, f2, _ = jm._fused_rhs(shape, True, False, True)(
            jnp.asarray(fg2), z, df1, alpha[1], beta[1] * dt)
    return dict(pm=pm, fg=fg, fg2=fg2, df1=np.asarray(df1),
                dt1max=float(jnp.max(dt1)), dt=np.float32(dt),
                df2=np.asarray(df2), f2=np.asarray(f2))


def test_rhs_zg_under_gz_matches_pallas(zg_kernels):
    """K6's (K6m's, K6s's, K6ms's) plain version under g_z(z): df and the
    max 1/dt."""
    pm = zg_kernels["pm"]
    assert fr.zg_library(pm) in fr.ZG_CHI_LIBRARIES
    df, dt1m = fr.rhs_zg(pm, *kernel_input(pm, zg_kernels["fg"]))
    np.testing.assert_allclose(float(dt1m), zg_kernels["dt1max"],
                               rtol=RTOL_DT)
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], zg_kernels["df1"][c], f"df[{c}]")


def test_rhs_zg_upd_under_gz_matches_pallas(zg_kernels):
    """K7's (K7m's, K7s's, K7ms's) plain version under g_z(z): df
    (written over df_prev) and f."""
    pm = zg_kernels["pm"]
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(zg_kernels["dt"])))
    df_prev = torch.tensor(zg_kernels["df1"])
    df, f = fr.rhs_zg_upd(pm, *kernel_input(pm, zg_kernels["fg2"]), df_prev,
                          coef)
    assert df is df_prev
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], zg_kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], zg_kernels["f2"][c], f"f[{c}]")


# ---- one zroll and one wrap_aux build under gravity --------------------------
AUX = {"shear_ns-sin": (shear_box, dict(shock=False), "sin-z",
                        "fused_rhs_shear_ns"),
       "shock_hydro-const": (shock_box, dict(magnetic=False), "const",
                             "fused_rhs_shock_hydro")}


@pytest.fixture(scope="module", params=sorted(AUX))
def aux_kernels(request):
    """The first and update Pallas kernels traced for a shear box without
    the shock slot (zroll, x/y-ghosted inputs with shifted x faces at t =
    0.37) or the hydro shocked box (wrap with the aux slot) under gravity,
    at 8×8×16; numpy results."""
    make, kw, prof, lib = AUX[request.param]
    shape = (8, 8, 16)

    def cfg(pkg):
        return sheared(pkg, with_gravity(pkg, make(shape, pkg=pkg, **kw),
                                         prof))

    rng = np.random.default_rng(7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(shape[0]))
        mp.setenv("PC_CX", str(shape[0]))
        jm = pj.Model(cfg(pj))
        pm = pt.Model(cfg(pt), device="cpu")
        wrap = pm.mode == "wrap_aux"
        nf, nvar = pm.reg.nf, pm.reg.nvar

        def noisy():
            fa = 1e-2 * rng.standard_normal((nf,) + shape)
            if nf > nvar:
                fa[nvar] = 5e-2 * rng.random(shape)
            return fa.astype(np.float32)

        fa, fa2 = noisy(), noisy()
        if not wrap:
            dj, _ = deltas(jm, pm)
            assert jm._fused_mode(None, dj, shape[2]) == "zroll"
            fa, fa2 = j_ghosted(jm, fa, dj), j_ghosted(jm, fa2, dj)
        z = jm.grid.z
        df1, dt1 = jm._fused_rhs(shape, False, wrap, False)(jnp.asarray(fa),
                                                            z)
        alpha, beta, _ = jm.rk
        dt = 1.0 / jnp.max(dt1)
        df2, f2, _ = jm._fused_rhs(shape, True, wrap, False)(
            jnp.asarray(fa2), z, df1, alpha[1], beta[1] * dt)
    return dict(pm=pm, lib=lib, wrap=wrap, fa=fa, fa2=fa2,
                df1=np.asarray(df1), dt1max=float(jnp.max(dt1)),
                dt=np.float32(dt), df2=np.asarray(df2), f2=np.asarray(f2))


def test_aux_kernels_under_gravity_match_pallas(aux_kernels):
    """K4n's or K1sh's plain version and their update's (K5n, K5wh) under
    gravity: df, the max 1/dt, and the update's df and f."""
    k = aux_kernels
    pm = k["pm"]
    assert fr.aux_library(pm) == k["lib"]
    first, upd = ((fr.rhs_wrap_shock, fr.rhs_wrap_shock_upd) if k["wrap"]
                  else (fr.rhs_zroll, fr.rhs_zroll_upd))
    df, dt1m = first(pm, torch.tensor(k["fa"]))
    np.testing.assert_allclose(float(dt1m), k["dt1max"], rtol=RTOL_DT)
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(k["dt"])))
    df2, f2 = upd(pm, torch.tensor(k["fa2"]), torch.tensor(k["df1"]), coef)
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], k["df1"][c], f"df[{c}]")
        assert_field_close(df2[c], k["df2"][c], f"df2[{c}]")
        assert_field_close(f2[c], k["f2"][c], f"f2[{c}]")


# ---- the gate ----------------------------------------------------------------
# every chain with gravity: (configuration, its mode, its library)
ADMITTED = {
    "flagship-sin": (lambda: strat_box(8, periodic=True, shear=False,
                                       forcing=0.05), "wrap", "fused_rhs"),
    "hydro-sin": (lambda: strat_box(8, periodic=True, shear=False,
                                    magnetic=False, forcing=0.05), "wrap",
                  "fused_rhs_hydro"),
    "ent_mhd-const": (lambda: with_gravity(pt, forced_entropy(8), "const"),
                      "wrap", "fused_rhs_ent"),
    "ent_hydro-zero": (lambda: forced_entropy(8, magnetic=False).replace(
        modules=forced_entropy(8, magnetic=False).modules
        + (pt.Gravity(gravz_profile="zero"),)), "wrap",
        "fused_rhs_hydro_ent"),
    "shear-ferriere": (lambda: shear_box(8).replace(
        modules=shear_box(8).modules + (pt.Gravity(
            gravz_profile="Ferriere", unit_length=3.086e21),)), "zroll",
        "fused_rhs_shear"),
    "shock_ent-linear": (lambda: with_gravity(pt, shock_box(
        8, entropy=True), "linear-z"), "wrap_aux", "fused_rhs_shock_ent"),
    "strat_ent": (lambda: strat_box(8, entropy=True), "zghost",
                  "fused_rhs_zg_mag_shear"),
    "strat_ent_hydro": (lambda: strat_box(8, entropy=True, magnetic=False),
                        "zghost", "fused_rhs_zg_shear"),
    "slab-sin": (lambda: with_gravity(pt, conv_slab(8), "sin-z"), "zghost",
                 "fused_rhs_zg"),
    "iso-sin": (lambda: with_gravity(pt, strat_box(
        8, magnetic=False, shear=False), "sin-z"), "zghost",
        "fused_rhs_zg_iso"),
}


@pytest.mark.parametrize("case", ADMITTED)
def test_gate_admits_gravity_on_every_chain(case):
    """Each chain takes gravity, every z profile: the mode, the library,
    launch names without a new suffix, and g_z(z) as the vector the
    kernels read (the z-ghosted ones after their layer profiles)."""
    make, mode, lib = ADMITTED[case]
    cfg = make()
    assert fused_mode(cfg) == (mode, None)
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    gz = fr.gravity_vector(pm)
    assert torch.equal(gz, cfg.module("gravity").gz(pm.grid.z))
    if mode == "zghost":
        assert fr.zg_library(pm) == lib
        prof = fr.zg_profiles(pm)
        assert prof[2] is gz
        assert (prof[0] is None) == ("ss" not in pm.reg.slots)
        names = fr.zg_kernels(pm)
    elif mode == "wrap":
        assert fr.flagship_library(pm) == lib
        names = tuple(k + fr.launch_suffix(pm) for k in fr._WRAP_KERNELS)
    else:
        assert fr.aux_library(pm) == lib
        names = fr.AUX_KERNELS[lib]
    assert all(n in fr.LAUNCHES for n in names)
    fr.kernel_params(pm)
    assert not hasattr(fr.PcParams, "gravz")


def test_gate_refuses_layers_in_a_periodic_box():
    """Entropy's cooling and heating layers stay refused outside the
    z-ghosted sets, under every profile, with an options reason before
    any admission; the plain path runs them on the CPU."""
    for prof in PROFILES:
        for make in (lambda: forced_entropy(8),
                     lambda: shock_box(8, entropy=True),
                     lambda: shear_box(8, entropy=True, shock=False)):
            cfg = with_gravity(pt, make(), prof)
            cfg = cfg.replace(modules=tuple(
                pt.Entropy(iheatcond=("chi-const",), chi=5e-3,
                           luminosity=5e-3) if m.name == "entropy" else m
                for m in cfg.modules))
            reason = gate_reason(cfg)
            assert reason.startswith("options "), reason
            assert "cool/luminosity" in reason
            with pytest.raises(NotImplementedError, match="cool/lumin"):
                pt.Model(cfg, device="cuda")
            assert pt.Model(cfg, device="cpu").mode is None


def test_profiles_that_are_not_z_only_raise():
    """gravx, an x profile, the central and the radial potentials raise
    as the module is built, naming the z profiles it has; K8 refuses a set
    with gravity."""
    for kw in (dict(gravx=1.0), dict(gravx_profile="kepler"),
               dict(gravz_profile="central"), dict(ipotential="newton")):
        with pytest.raises(NotImplementedError, match="sin-z"):
            pt.Gravity(**kw)
    cfg = with_gravity(pt, pt.configs.flagship(8, dt=1e-3), "sin-z")
    with pytest.raises(NotImplementedError, match="K8"):
        pt.Model(cfg, device="cpu", fake_rhs=True)


# ---- the converters ----------------------------------------------------------
LAYOUTS = {"strat_ent": dict(entropy=True),
           "strat_ent_hydro": dict(entropy=True, magnetic=False),
           "strat_periodic": dict(periodic=True, shear=False, forcing=0.05),
           "strat_periodic_hydro": dict(periodic=True, shear=False,
                                        magnetic=False, forcing=0.05)}


@pytest.mark.parametrize("case", LAYOUTS)
def test_jax_state_converts(case, tmp_path):
    """A JAX state of each new layout crosses as numpy through
    overrides_from_numpy and its var.npz through snapshot_from_jax, bit for
    bit, t included; it steps on, finite."""
    jm = pj.Model(strat_box(8, pkg=pj, fused=False, **LAYOUTS[case]))
    pm = pt.Model(strat_box(8, **LAYOUTS[case]), device="cpu")
    js = jm.init_state(4)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    over = overrides_from_numpy(fields, pm.reg)
    assert list(over) == list(pm.reg.slots)
    save_snapshot(tmp_path / "var.npz", js)
    snap = snapshot_from_jax(tmp_path / "var.npz", pm)
    for k, v in fields.items():
        np.testing.assert_array_equal(snap["fields"][k].numpy(), v, k)
    assert float(snap["t"]) == float(js["t"])
    out = pm.make_step()(snap)
    assert all(bool(torch.isfinite(v).all()) for v in out["fields"].values())
