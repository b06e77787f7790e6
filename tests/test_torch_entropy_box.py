"""Non-isothermal forced turbulence (the flagship with an entropy field,
with and without Magnetic) in pencil_tpu_torch against pencil_tpu: the
entropy instances of the flagship template (K1e … K2Le on 8 fields, K1he …
K2Lhe on 5; plain versions on the CPU) against the Pallas kernels they
replace, the Ohmic-heating term of the eager path, the kernel constants,
the gate and the state converters.  The 5-field instances are in
test_torch_entropy_hydro_kernels.py, the chains' steps in
test_torch_entropy_steps.py.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode.  Bounds are those of tests/test_fused.py: each
field within 2e-5 × its max, the CFL maximum within 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import (overrides_from_numpy,
                                              snapshot_from_jax)
from pencil_tpu_torch.configs import conv_slab, forced_entropy
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_model import assert_states_close
from test_torch_rk_orders import assert_field_close

torch.set_num_threads(1)

RTOL_DT = 1e-6


def config(pkg, n=16, magnetic=True, itorder=3, fused=True, Omega=0.0,
           entropy=None, **time):
    """configs.forced_entropy at a 2N-RK order; ``entropy`` = keyword
    arguments of another Entropy module in place of its chi-const one."""
    cfg = forced_entropy(n, magnetic=magnetic, fused=fused, pkg=pkg,
                         Omega=Omega)
    if entropy is not None:
        cfg = dataclasses.replace(cfg, modules=tuple(
            pkg.Entropy(**entropy) if m.name == "entropy" else m
            for m in cfg.modules))
    return dataclasses.replace(cfg, time=dataclasses.replace(
        cfg.time, itorder=itorder, **time))


K_AND_CHI = dict(iheatcond=("chi-const", "K-const"), chi=5e-3, hcond0=4e-3)


def ent_fields(shape, seed, z, magnetic=True, aa_ampl=1e-3):
    """uu, lnrho, ss and aa as numpy, the same for both packages."""
    rng = np.random.default_rng(seed)

    def noise(ampl, *lead):
        return (ampl * rng.standard_normal(lead + shape)).astype(np.float32)

    out = {"uu": noise(1e-2, 3),
           "lnrho": (0.05 * np.sin(z)[None, None, :]
                     + noise(1e-3)).astype(np.float32),
           "ss": (0.02 * np.cos(z)[None, None, :]
                  + noise(1e-3)).astype(np.float32)}
    if magnetic:
        out["aa"] = noise(aa_ampl, 3)
    return out


# ---- the entropy instances against the Pallas kernels ----------------------
def noisy_fa(nvar, shape, seed):
    rng = np.random.default_rng(seed)
    amp = np.array([1e-2] * 3 + [5e-2] + [1e-2] * (nvar - 4))
    return (amp[:, None, None, None]
            * rng.standard_normal((nvar,) + shape)).astype(np.float32)


# the 8-field set here; the 5-field set runs the same tests from
# test_torch_entropy_hydro_kernels.py, so that two workers share the
# interpret-mode Pallas calls
CASES = {"mhd-16": (True, (16, 16, 16), None),
         "mhd-8x8x16-K": (True, (8, 8, 16), K_AND_CHI)}


@pytest.fixture(scope="module", params=sorted(CASES))
def kernels(request):
    return build_kernels(*CASES[request.param])


def build_kernels(magnetic, shape, entropy):
    """Every wrap-mode call shape of the JAX package (interpret mode) built
    for one of the two entropy sets, on numpy inputs; numpy results.  The
    K cases add K-const conduction, whose CFL rate varies per point."""
    out = pallas_calls(
        config(pj, n=shape, magnetic=magnetic, entropy=entropy),
        config(pt, n=shape, magnetic=magnetic, entropy=entropy))
    assert out["nvar"] == (8 if magnetic else 5)
    return out


def pallas_calls(jcfg, pcfg):
    """Every wrap-mode call shape of the JAX package (interpret mode)
    built for ``jcfg`` on numpy inputs, the port's CPU model of ``pcfg``
    beside them; numpy results."""
    jm = pj.Model(jcfg)
    pm = pt.Model(pcfg, device="cpu")
    shape = jm.cfg.grid.shape
    nvar = pm.reg.nvar
    fa, fa2 = noisy_fa(nvar, shape, 3), noisy_fa(nvar, shape, 4)
    z = jm.grid.z
    alpha, beta, _ = jm.rk
    df1, dt1 = jm._fused_rhs(shape, False, True, False)(jnp.asarray(fa), z)
    dt = np.float32(1.0 / float(jnp.max(dt1)))
    out = dict(pm=pm, nvar=nvar, fa=fa, fa2=fa2, df1=np.asarray(df1),
               dt1max=float(jnp.max(dt1)))
    out["coef2"] = np.array([alpha[1], beta[1] * dt, beta[0] * dt],
                            np.float32)
    out["coef3"] = np.array([alpha[2], beta[2] * dt, 0.0], np.float32)
    df2, f2 = jm._fused_rhs(shape, True, True, False, True, False, False)(
        jnp.asarray(fa), z, df1, alpha[1], beta[1] * dt, cprev=beta[0] * dt)
    out["df2"], out["f2"] = np.asarray(df2), np.asarray(f2)
    kick = jm.cfg.module("forcing").kick_coeffs(
        jax.random.PRNGKey(8), jnp.float32(dt), jm.cfg, jm.eos, jnp.float32)
    out["kick"] = np.concatenate([np.ravel(np.asarray(k)) for k in kick]
                                 + [np.zeros(1)]).astype(np.float32)
    for k in (None, kick):
        out["last", k is None] = np.asarray(jm._fused_rhs(
            shape, True, True, False, False, True, k is not None)(
            f2, z, df2, alpha[2], beta[2] * dt, kick=k))
        out["defer_last", k is None] = np.asarray(jm._fused_rhs(
            shape, True, True, False, True, True, k is not None)(
            jnp.asarray(fa2), z, df1, alpha[2], beta[2] * dt,
            cprev=beta[1] * dt, kick=k))
    # the order-4 middle substeps' call (kernel_upd with the wrap fetch)
    mid = jm._fused_rhs(shape, True, True, False, False, False, False)
    df, f, _ = mid(jnp.asarray(fa2), z, df1, alpha[2], beta[2] * dt)
    out["mid"] = (np.asarray(df), np.asarray(f))
    return out


def test_rhs_first_ent_matches_pallas(kernels):
    """K1e/K1he's plain version: df of every field, ss included, and the
    max 1/dt with χγ (and K γ/(ρ cp) per point) in the diffusive rate."""
    df, dt1m = fr.rhs_first(kernels["pm"], torch.tensor(kernels["fa"]))
    assert df.shape == kernels["fa"].shape and dt1m.ndim == 0
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(kernels["nvar"]):
        assert_field_close(df[c], kernels["df1"][c], f"df1[{c}]")


def test_rhs_tail_defer_ent_matches_pallas(kernels):
    """K2e/K2he's plain version: df2 and f2 from raw f0 and df1."""
    df2, f2 = fr.rhs_tail_defer(kernels["pm"], torch.tensor(kernels["fa"]),
                                torch.tensor(kernels["df1"]),
                                torch.tensor(kernels["coef2"]))
    for c in range(kernels["nvar"]):
        assert_field_close(df2[c], kernels["df2"][c], f"df2[{c}]")
        assert_field_close(f2[c], kernels["f2"][c], f"f2[{c}]")


@pytest.mark.parametrize("kicked", (False, True), ids=("unforced", "kick"))
def test_rhs_tail_last_ent_matches_pallas(kernels, kicked):
    """K3e/K3he's plain version, with and without the helical kick (on uu
    only, whatever the number of fields)."""
    kick = torch.tensor(kernels["kick"]) if kicked else None
    f3 = fr.rhs_tail_last(kernels["pm"], torch.tensor(kernels["f2"]),
                          torch.tensor(kernels["df2"]),
                          torch.tensor(kernels["coef3"]), kick)
    for c in range(kernels["nvar"]):
        assert_field_close(f3[c], kernels["last", not kicked][c], f"f3[{c}]")


@pytest.mark.parametrize("kicked", (False, True), ids=("unforced", "kick"))
def test_rhs_tail_defer_last_ent_matches_pallas(kernels, kicked):
    """K2Le/K2Lhe's plain version: f rebuilt from raw f0 and df1, updated
    and kicked."""
    kick = torch.tensor(kernels["kick"]) if kicked else None
    coef = kernels["coef3"].copy()
    coef[2] = kernels["coef2"][1]
    f = fr.rhs_tail_defer_last(kernels["pm"], torch.tensor(kernels["fa2"]),
                               torch.tensor(kernels["df1"]),
                               torch.tensor(coef), kick)
    for c in range(kernels["nvar"]):
        assert_field_close(f[c], kernels["defer_last", not kicked][c],
                           f"f[{c}]")


def test_rhs_tail_mid_ent_matches_pallas(kernels):
    """K3′e/K3′he's plain version against the ``kernel_upd`` call: df
    (written over df_prev) and f."""
    df_prev = torch.tensor(kernels["df1"])
    df, f = fr.rhs_tail_mid(kernels["pm"], torch.tensor(kernels["fa2"]),
                            df_prev, torch.tensor(kernels["coef3"]))
    assert df is df_prev
    for c in range(kernels["nvar"]):
        assert_field_close(df[c], kernels["mid"][0][c], f"df[{c}]")
        assert_field_close(f[c], kernels["mid"][1][c], f"f[{c}]")


# ---- Ohmic heating in the eager path -----------------------------------------
def test_ohmic_heating_matches_jax_jnp_path():
    """Magnetic publishes η J² and Entropy adds it over ρT, as the JAX
    modules do: the eager CPU step of {eos γ = 5/3, density, hydro,
    viscosity, magnetic η = 5e-3, entropy} against the JAX jnp path, 3
    steps at 16³, with a field strong enough that the heating shows in
    ss."""
    def cfg(pkg):
        return pkg.Config(
            grid=pkg.GridSpec(nx=16, ny=16, nz=16),
            time=pkg.TimeSpec(itorder=3), fused=False,
            modules=(pkg.EosIdealGas(gamma=5.0 / 3.0), pkg.Density(),
                     pkg.Hydro(), pkg.Viscosity(ivisc=("nu-const",),
                                                nu=5e-3),
                     pkg.Magnetic(eta=5e-3), pkg.Entropy()))

    jm, pm = pj.Model(cfg(pj)), pt.Model(cfg(pt), device="cpu")
    assert pm.mode is None          # the eager path
    fields = ent_fields((16, 16, 16), 21, pm.grid.z.numpy(), aa_ampl=3e-2)
    fields["ss"] = np.zeros_like(fields["ss"])
    js = jm.init_state(1, overrides=fields)
    ps = pm.init_state(1, overrides=fields)
    jstep = jax.jit(jm.make_step())
    for _ in range(3):
        js, ps = jstep(js), pm.make_step()(ps)
    ss_j = np.asarray(js["fields"]["ss"], np.float64)
    err = np.abs(ps["fields"]["ss"].numpy() - ss_j).max()
    assert err <= 2e-5 * np.abs(ss_j).max(), err
    assert_states_close(js, ps)


def test_lohmic_heat_off_publishes_nothing():
    """``Magnetic(lohmic_heat=False)`` leaves ss to the viscous heating
    alone, in the module and in the kernel constants."""
    def run(**mag):
        cfg = config(pt, n=8).replace(modules=tuple(
            pt.Magnetic(eta=5e-3, **mag) if m.name == "magnetic" else m
            for m in config(pt, n=8).modules))
        pm = pt.Model(cfg, device="cpu")
        fa = torch.tensor(noisy_fa(8, (8, 8, 8), 2))
        return fr.rhs_first(pm, fa)[0][4], fr.kernel_params(pm).eta_heat

    on, eta_on = run()
    off, eta_off = run(lohmic_heat=False)
    assert eta_on == np.float32(5e-3) and eta_off == 0.0
    assert float((on - off).min()) >= 0.0 and float((on - off).max()) > 0.0


# ---- the kernel constants -----------------------------------------------
def test_kernel_params_take_the_entropy_layouts():
    """The template's constants for the 8- and 5-field layouts, each with
    its library and launch suffix; χγ joins ν and η in the constant
    diffusive rate, K-const stays per point."""
    mhd = pt.Model(config(pt, n=8), device="cpu")
    hyd = pt.Model(config(pt, n=8, magnetic=False), device="cpu")
    assert fr.flagship_library(mhd) == "fused_rhs_ent"
    assert fr.flagship_library(hyd) == "fused_rhs_hydro_ent"
    assert fr.launch_suffix(mhd) == "_ent"
    assert fr.launch_suffix(hyd) == "_hydro_ent"
    assert mhd.reg.comp_names == ["ux", "uy", "uz", "lnrho", "ss",
                                  "ax", "ay", "az"]
    pm, ph = fr.kernel_params(mhd), fr.kernel_params(hyd)
    f32 = np.float32
    for p in (pm, ph):
        assert p.isothermal == 0
        assert p.g_cp == f32(5.0 / 3.0) and p.gm1 == f32(2.0 / 3.0)
        assert p.cpchi == f32(5e-3) and p.hcond0 == 0.0
        assert p.two_nu == f32(1e-2)
        assert p.maxdif == f32(5e-3 * 5.0 / 3.0)       # χγ > ν = η
        inv = f32(8 / (2 * np.pi))
        dxyz2 = (inv * inv + inv * inv) + inv * inv
        assert p.dif == f32(5e-3 * 5.0 / 3.0) * dxyz2 / f32(0.25)
    assert pm.eta_heat == f32(5e-3) and ph.eta_heat == 0.0
    pk = fr.kernel_params(pt.Model(config(pt, n=8, entropy=K_AND_CHI),
                                   device="cpu"))
    assert pk.hcond0 == f32(4e-3) and pk.cpchi == f32(5e-3)
    names = fr.library_instances("fused_rhs_ent")
    assert "rhs_tail_last_ent kick" in names
    assert not any("fake" in n for n in names)         # no K8 with ss


# ---- the gate -----------------------------------------------------------
@pytest.mark.parametrize("itorder", (1, 2, 3, 4))
@pytest.mark.parametrize("magnetic", (True, False), ids=("mhd", "hydro"))
@pytest.mark.parametrize("variant", ("forced", "unforced", "rotating",
                                     "K-const"))
def test_gate_accepts_the_entropy_sets(variant, magnetic, itorder):
    """Both sets, without forcing, with Ω and with K-const conduction, at
    every 2N-RK order, run the wrap chain on the card and on the CPU."""
    cfg = config(pt, magnetic=magnetic, itorder=itorder,
                 Omega=1.0 if variant == "rotating" else 0.0,
                 entropy=K_AND_CHI if variant == "K-const" else None)
    if variant == "unforced":
        cfg = cfg.replace(modules=cfg.modules[:-1])
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    assert pt.Model(cfg, device="cpu").mode == "wrap"


REFUSED = {
    "cool": (dict(cool=15.0, cs2cool=1.0), (), "cool/luminosity"),
    "luminosity": (dict(luminosity=5e-3), (), "cool/luminosity"),
    # gravity runs on the entropy builds; under it the layers still do not
    "gravity": (dict(cool=15.0, cs2cool=1.0),
                (pt.Gravity(gravz_profile="const", gravz=-1.0),),
                "cool/luminosity"),
    # del6 in both flavours on u: no H3 instance has two weights a field
    "hyper3": (None, (), "hyper3-mesh"),
}


@pytest.mark.parametrize("magnetic", (True, False), ids=("mhd", "hydro"))
@pytest.mark.parametrize("case", sorted(REFUSED))
def test_gate_refuses_what_the_entropy_kernels_lack(case, magnetic):
    """The layer profiles stay outside, also under gravity: a reason on
    the CPU (the eager path), NotImplementedError on the card.  Of del6
    hyper-diffusion the H3 instances take one flavour a field: 'hyper3-
    mesh' beside 'hyper3-simplified' is refused with its name (each alone
    runs: test_gate_admits_the_mesh_flavour_on_the_entropy_sets)."""
    entropy, extra, word = REFUSED[case]
    cfg = config(pt, magnetic=magnetic, entropy=entropy)
    cfg = cfg.replace(modules=cfg.modules + extra)
    if case == "hyper3":
        cfg = cfg.replace(modules=tuple(
            pt.Viscosity(ivisc=("nu-const", "hyper3-simplified",
                                "hyper3-mesh"), nu=5e-3, nu_hyper3=1e-9)
            if m.name == "viscosity" else m for m in cfg.modules))
    assert word in gate_reason(cfg)
    assert fused_gate(cfg, "cpu") is False
    with pytest.raises(NotImplementedError, match=word):
        fused_gate(cfg, "cuda")
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode is None
    with pytest.raises(NotImplementedError,
                       match=word if case == "hyper3" else "layout"):
        fr.kernel_params(pm)


@pytest.mark.parametrize("magnetic", (True, False), ids=("mhd", "hydro"))
def test_gate_admits_the_mesh_flavour_on_the_entropy_sets(magnetic):
    """Both entropy sets with 'hyper3-mesh' viscosity and
    diffrho_hyper3_mesh (η₃ on A with Magnetic) run the wrap chain on
    their builds' H3 instances with the mesh weights, counted under the
    launch names with _h3; the JAX package has the flavour too."""
    cfg = forced_entropy(8, magnetic=magnetic, hyper3="mesh")
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode == "wrap" and fr.launch_suffix(pm).endswith("_h3")
    p = fr.kernel_params(pm)
    assert p.hmesh > 0.0 and p.nu3 > 0.0 and p.diff3 > 0.0
    jcfg = forced_entropy(8, pkg=pj, magnetic=magnetic, hyper3="mesh")
    assert jcfg.module("viscosity").ivisc == ("nu-const", "hyper3-mesh")


@pytest.mark.parametrize("magnetic", (True, False), ids=("mhd", "hydro"))
def test_gate_admits_hyper3_on_the_entropy_sets(magnetic):
    """Both entropy sets with 'hyper3-simplified' viscosity (and η₃ with
    Magnetic, D₃) run the wrap chain on their builds' H3 instances, counted
    under the launch names with _h3."""
    cfg = config(pt, magnetic=magnetic).replace(modules=tuple(
        pt.Viscosity(ivisc=("nu-const", "hyper3-simplified"), nu=5e-3,
                     nu_hyper3=1e-9) if m.name == "viscosity" else m
        for m in config(pt, magnetic=magnetic).modules))
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode == "wrap"
    assert fr.launch_suffix(pm) == ("_ent_h3" if magnetic
                                    else "_hydro_ent_h3")
    assert fr.kernel_params(pm).nu3 == np.float32(1e-9)


def test_gate_admits_chi_const_on_the_conv_slab():
    """The z-ghosted builds' CHI instances take chi-const beside K-const:
    the conv-slab set with it runs the zghost chain, and so does the same
    set with D₃ del6 hyper-diffusion (their H3 instances) and with its
    'mesh' flavour (the same instances with the mesh weights); both
    flavours of D₃ at once are refused on the card, with the option's
    name."""
    cfg = conv_slab(8)
    cfg = cfg.replace(modules=tuple(
        dataclasses.replace(m, iheatcond=("K-const", "chi-const"), chi=1e-3)
        if m.name == "entropy" else m for m in cfg.modules))
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    assert pt.Model(cfg, device="cpu").mode == "zghost"
    hyper = cfg.replace(modules=tuple(
        pt.Density(init="piecew-poly", diffrho_hyper3=1e-9)
        if m.name == "density" else m for m in cfg.modules))
    assert gate_reason(hyper) is None
    assert fused_gate(hyper, "cuda") is True
    assert pt.Model(hyper, device="cpu").mode == "zghost"
    mesh = cfg.replace(modules=tuple(
        pt.Density(init="piecew-poly", diffrho_hyper3_mesh=5.0)
        if m.name == "density" else m for m in cfg.modules))
    assert gate_reason(mesh) is None
    assert fused_gate(mesh, "cuda") is True
    both = cfg.replace(modules=tuple(
        pt.Density(init="piecew-poly", diffrho_hyper3=1e-9,
                   diffrho_hyper3_mesh=5.0)
        if m.name == "density" else m for m in cfg.modules))
    with pytest.raises(NotImplementedError, match="diffrho_hyper3_mesh"):
        fused_gate(both, "cuda")
    assert gate_reason(conv_slab(8)) is None


def test_fake_rhs_refuses_the_entropy_sets():
    """K8 is built for the isothermal MHD flagship only."""
    for magnetic in (True, False):
        with pytest.raises(NotImplementedError, match="K8"):
            pt.Model(config(pt, n=8, magnetic=magnetic, dt=1e-3),
                     fake_rhs=True, device="cpu")


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


# ---- the state converters -------------------------------------------------
@pytest.mark.parametrize("magnetic", (True, False), ids=("mhd", "hydro"))
def test_jax_entropy_state_converts(magnetic, tmp_path):
    """A JAX state of either set crosses as numpy through
    overrides_from_numpy, and a JAX var.npz through snapshot_from_jax,
    and starts the port's state bit for bit."""
    from pencil_tpu.io.snapshot import save_snapshot
    jm = pj.Model(config(pj, n=8, magnetic=magnetic))
    pm = pt.Model(config(pt, n=8, magnetic=magnetic), device="cpu")
    js = jm.init_state(4)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    over = overrides_from_numpy(fields, pm.reg)
    assert list(over) == (["uu", "lnrho", "ss", "aa"] if magnetic
                          else ["uu", "lnrho", "ss"])
    ps = pm.init_state(4, overrides=over)
    for k, v in fields.items():
        np.testing.assert_array_equal(ps["fields"][k].numpy(), v, k)
    save_snapshot(tmp_path / "var.npz", js)
    snap = snapshot_from_jax(tmp_path / "var.npz", pm)
    assert list(snap["fields"]) == list(pm.reg.slots)
    for k, v in fields.items():
        np.testing.assert_array_equal(snap["fields"][k].numpy(), v, k)
    assert float(snap["t"]) == float(js["t"])
    assert float(snap["dt"]) == float(js["dt"])
    assert int(snap["it"]) == 0 and snap["it"].dtype == torch.int32
    pm.make_step()(snap)                      # it steps on from there
    with pytest.raises(KeyError):
        overrides_from_numpy({"uu": fields["uu"]}, pm.reg)


def test_conv_slab_layout_is_not_the_template_s():
    """The conv-slab set has the 5-field layout too, but with gravity and
    the layer profiles: it keeps its own kernels."""
    pm = pt.Model(conv_slab(8), device="cpu")
    assert pm.mode == "zghost"
    with pytest.raises(NotImplementedError, match="layout"):
        fr.flagship_library(pm)
